"""Logical-axis sharding of the port (the reference's MaxText-style rules).

The reference annotates arrays (``NamedSharding``, ``with_sharding_constraint``)
and lets GSPMD partition the program. The port's mesh is single-controller
(``launch.mesh``): one process drives every rank and each rank's tensors live
on its device. So here a sharding is an object that PLACES a tensor: a
``NamedSharding(mesh, spec)`` cuts a full tensor into per-rank blocks
(``shard``) and puts them back together (``gather``), and the model code
(``distributed.tensor_parallel``) computes on the blocks with explicit
collectives.

The rule tables are the reference's, copied: ``ACT_RULES`` (activation
layouts, batch over every data-parallel axis, heads / vocab / ffn over
``model``), ``PARAM_RULES`` (leaf path -> trailing-dim spec: column-parallel
up / qkv / gate projections, row-parallel down / out projections, expert d_ff
over ``model``), ``param_spec_fsdp`` and ``cache_shardings``. Specs
(``PartitionSpec``) compare equal to the tuple of their entries: ``None``, an
axis name or a tuple of axis names.

A dim that does not divide its axes' size is split into ceil-sized blocks,
the last zero-padded (what GSPMD does with an uneven split); ``gather`` crops
the padding. ``row_sharding`` is the serving layout of database rows.
"""
from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed import collectives as C

_STATE = threading.local()


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# activation layouts: batch is sharded over every data-parallel axis,
# heads/vocab/ffn over "model"; long-context KV shards sequence over "data"
ACT_RULES = {
    "btd": lambda dp: P(dp, None, None),
    # Megatron-SP: residual stream sharded over (batch→dp, seq→model) —
    # activation memory /16 between blocks, TP all-reduces become
    # reduce-scatter + all-gather pairs. Toggled via set_sequence_parallel.
    "btd_sp": lambda dp: P(dp, "model", None),
    "btv": lambda dp: P(dp, None, "model"),
    "bthd": lambda dp: P(dp, None, "model", None),
    "kv_seq": lambda dp: P(None, "data", "model", None),
    "moe_ecd": lambda dp: P(None, dp, None),   # (experts, capacity, d)
    "td": lambda dp: P(dp, None),
}

_SEQ_PARALLEL = False


def set_sequence_parallel(on: bool):
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = on


def sequence_parallel() -> bool:
    return _SEQ_PARALLEL


def _dp_axes(mesh):
    axes = [a for a in mesh.axis_names if a in ("pod", "data")]
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axes_size(mesh, entry) -> int:
    n = 1
    for a in _axes_of(entry):
        n *= int(mesh.shape[a])
    return n


def act_spec(layout: str, ndim: int, mesh, seq_len: int | None = None) -> PartitionSpec:
    """The spec ``shard_act`` gives a ``layout`` activation of ``ndim`` dims:
    ``btd`` becomes ``btd_sp`` under sequence parallelism when the sequence
    divides the model axis; the spec is padded with (or cut to) ``ndim``
    entries, as the reference's is."""
    if layout == "btd" and _SEQ_PARALLEL and ndim >= 2 and seq_len is not None \
            and seq_len % mesh.shape.get("model", 1) == 0:
        layout = "btd_sp"
    spec = ACT_RULES[layout](_dp_axes(mesh))
    if len(spec) < ndim:
        return P(*(tuple(spec) + (None,) * (ndim - len(spec))))
    return P(*tuple(spec)[:ndim])


class Act:
    """An activation in the per-rank form the model code computes on:
    ``parts[d]`` is data rank d's tensor (the same on every model rank) or,
    laid out ``btd_sp``, a tuple of the model ranks' sequence blocks."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)


def shard_act(x, layout: str):
    """The identity outside a mesh, as in the reference. Inside one, a full
    tensor is placed by the layout's spec (``NamedSharding.shard``: its
    per-rank blocks), and an ``Act`` is laid out as the layout says: under
    sequence parallelism ``btd`` cuts each data rank's residual stream into
    the model ranks' sequence blocks (a slice: each rank keeps its own), and
    without it joins such blocks again (an all-gather, recorded)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if isinstance(x, Act):
        from repro_torch.distributed import tensor_parallel as TP
        return TP.lay_out(mesh, x, layout)
    return NamedSharding(mesh, act_spec(layout, x.ndim, mesh,
                                        x.shape[1] if x.ndim >= 2 else None)).shard(x)


# ---- parameter sharding rules (path-keyword -> trailing-dim base spec) ----
#
# Base specs cover the TRAILING dims of the (possibly layer-stacked) tensor;
# leading stacked axes are padded with None. Tensor-parallel on "model":
# column-parallel for up/qkv/gate projections, row-parallel for
# down/out projections. MoE experts use expert-tensor-parallelism (expert
# d_ff over "model") because granite's 40/32 expert counts don't divide 16.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"conv_w$|conv_b$|A_log$|/D$|dt_bias$|bias$|ln|norm|scale$|f_bias$|"
     r"r_rec$|router$|i_gate$|f_gate$", ()),               # replicated
    (r"wq$|wk$|wv$|/q$|/k$|/v$|w_gate$|w_up$|up_proj$|in_proj$|w_in$",
     (None, "model")),
    (r"wo$|out_proj$|down_proj$|w_down$", ("model", None)),
    (r"embed$|lm_head$", (None, "model")),
    (r"b[qkv]$", ("model",)),
]


def _path_str(path) -> str:
    """A leaf path (keys from ``tree_map_with_path``) as the reference
    spells it: dict keys and indices joined by "/", a NamedTuple field as
    ".name"."""
    return "/".join(str(p) for p in path)


def param_spec(path, leaf) -> PartitionSpec:
    s = "/" + _path_str(path)
    nd = leaf.ndim
    for pat, base in PARAM_RULES:
        if re.search(pat, s):
            base = tuple(base)
            if len(base) > nd:
                base = base[-nd:]
            return P(*((None,) * (nd - len(base)) + base))
    return P(*([None] * nd))


def param_spec_fsdp(path, leaf, mesh) -> PartitionSpec:
    """FSDP: shard each tensor's largest divisible dim over ALL mesh axes
    (fall back to the data axes, then to replication). Activations stay
    batch-sharded; per-layer param all-gathers replace the per-token TP
    all-reduces."""
    all_axes = tuple(mesh.axis_names)
    candidates = [all_axes,
                  tuple(a for a in all_axes if a != "model") or all_axes]
    nd = leaf.ndim
    if nd == 0:
        return P()
    order = sorted(range(nd), key=lambda ax: -leaf.shape[ax])
    for axes in candidates:
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        for ax in order:
            if leaf.shape[ax] % total == 0 and leaf.shape[ax] >= total:
                spec = [None] * nd
                spec[ax] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return P(*([None] * nd))


class _Field(str):
    """A NamedTuple field in a leaf path (prints ".name", as JAX's)."""

    def __new__(cls, name):
        return super().__new__(cls, "." + name)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, NamedTuples, lists and
    tuples, in the tree's shape; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (_Field(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def leaves_with_path(tree, path=()) -> list:
    """(path, leaf) pairs in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in leaves_with_path(v, path + (_Field(f),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over trees of one structure (dicts, NamedTuples,
    lists, tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` over ``mesh``: dim k with entry ``e`` is cut into
    ``prod(mesh.shape[a] for a in e)`` blocks, the rank's block index being
    its coordinates along ``e``'s axes (the first axis major). ``mode`` is
    the parameter layout it came from ("tp" or "fsdp"; the model's sharded
    path reads it)."""

    mesh: object
    spec: PartitionSpec
    mode: str = "tp"

    def split(self, ndim: int) -> list[tuple[int, tuple]]:
        """(dim, axes) of every split dim."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [(k, _axes_of(e)) for k, e in enumerate(spec) if e is not None]

    def block_shape(self, shape) -> tuple:
        out = list(shape)
        for k, axes in self.split(len(shape)):
            out[k] = -(-shape[k] // _axes_size(self.mesh, axes))
        return tuple(out)

    def block_index(self, coord: tuple, ndim: int) -> tuple:
        """Per split dim, the block that the rank at grid ``coord`` holds."""
        names = self.mesh.axis_names
        out = []
        for _, axes in self.split(ndim):
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + coord[names.index(a)]
            out.append(idx)
        return tuple(out)

    def shard(self, x) -> "Blocks":
        """Per-rank blocks of ``x`` (a tensor or a host array), each on its
        rank's device. Ranks that hold the same block on the same device
        share one tensor (a view of ``x`` where nothing is padded)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.ascontiguousarray(x))
        shape, nd = tuple(x.shape), x.ndim
        bshape = self.block_shape(shape)
        pads = [(k, bshape[k] * _axes_size(self.mesh, axes) - shape[k])
                for k, axes in self.split(nd)]
        if any(p for _, p in pads):
            padded = list(shape)
            for k, p in pads:
                padded[k] += p
            full = x.new_zeros(padded)
            full[tuple(slice(0, s) for s in shape)] = x
            x = full
        grid = np.empty(self.mesh.devices.shape, dtype=object)
        made: dict = {}
        for coord in np.ndindex(*grid.shape):
            dev = self.mesh.devices[coord]
            idx = self.block_index(coord, nd)
            key = (idx, str(dev))
            if key not in made:
                sl = [slice(None)] * nd
                for (k, _), i in zip(self.split(nd), idx):
                    sl[k] = slice(i * bshape[k], (i + 1) * bshape[k])
                made[key] = x[tuple(sl)].to(dev)
            grid[coord] = made[key]
        return Blocks(self, shape, grid)

    def gather(self, blocks: "Blocks", home=None, first=None) -> torch.Tensor:
        """The full tensor from its blocks, on ``home`` (the mesh's home by
        default), the padding cropped; each block is read from the first
        rank holding it, in ``first``'s order of grid coordinates if given.
        Differentiable (cat and slices)."""
        home = self.mesh.home if home is None else torch.device(home)
        nd = len(blocks.shape)
        split = self.split(nd)
        by_index = {}
        for coord in (np.ndindex(*blocks.grid.shape) if first is None else first):
            by_index.setdefault(self.block_index(coord, nd), blocks.grid[coord])
        counts = [_axes_size(self.mesh, axes) for _, axes in split]

        def build(level: int, prefix: tuple):
            if level == len(split):
                return by_index[prefix].to(home)
            return torch.cat([build(level + 1, prefix + (i,)) for i in range(counts[level])],
                             dim=split[level][0])
        out = build(0, ())
        if tuple(out.shape) != tuple(blocks.shape):
            out = out[tuple(slice(0, s) for s in blocks.shape)]
        return out


@dataclass(eq=False)
class Blocks:
    """A tensor placed on a mesh: ``grid`` (an object ndarray in the mesh's
    grid shape) holds each rank's block; ``shape`` is the full tensor's."""

    sharding: NamedSharding
    shape: tuple
    grid: np.ndarray

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.grid.flat[0].dtype

    def gather(self, home=None) -> torch.Tensor:
        return self.sharding.gather(self, home)

    def distinct(self) -> list[tuple[tuple, torch.Tensor]]:
        """(first grid coordinate, tensor) of each distinct block object."""
        seen, out = set(), []
        for coord in np.ndindex(*self.grid.shape):
            t = self.grid[coord]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((coord, t))
        return out

    def astype(self, dtype) -> "Blocks":
        """The blocks cast to ``dtype`` (replicas still shared); ``self``
        when they are in it already."""
        if self.dtype == dtype:
            return self
        cast = {id(t): t.to(dtype) for _, t in self.distinct()}
        grid = np.empty(self.grid.shape, dtype=object)
        for coord in np.ndindex(*grid.shape):
            grid[coord] = cast[id(self.grid[coord])]
        return Blocks(self.sharding, self.shape, grid)

    def box(self, coord: tuple) -> list[tuple[int, int]]:
        """Per dim, the [start, stop) of the full tensor that the block of
        rank ``coord`` holds (its zero padding cut off)."""
        nd, sh = len(self.shape), self.sharding
        bshape = sh.block_shape(self.shape)
        out = [(0, s) for s in self.shape]
        for (k, _), i in zip(sh.split(nd), sh.block_index(coord, nd)):
            out[k] = (min(i * bshape[k], self.shape[k]), min((i + 1) * bshape[k], self.shape[k]))
        return out

    def unbind(self) -> list["Blocks"]:
        """The blocks of each index of an unsplit leading axis (a layer
        stack): views, replicas still shared."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"unbind along a split axis ({self.spec})")
        sh = NamedSharding(self.sharding.mesh, P(*tuple(self.spec)[1:]), self.sharding.mode)
        per = {}
        for _, t in self.distinct():
            per[id(t)] = torch.unbind(t)
        out = []
        for i in range(self.shape[0]):
            grid = np.empty(self.grid.shape, dtype=object)
            for coord in np.ndindex(*grid.shape):
                grid[coord] = per[id(self.grid[coord])][i]
            out.append(Blocks(sh, self.shape[1:], grid))
        return out


def placed_zeros(sharding: NamedSharding, shape, dtype) -> Blocks:
    """A zero tensor of ``shape`` placed by ``sharding``, each rank's block
    made on its device (one per distinct block and device), no full tensor
    made first."""
    shape = tuple(int(s) for s in shape)
    bshape = sharding.block_shape(shape)
    grid = np.empty(sharding.mesh.devices.shape, dtype=object)
    made: dict = {}
    with C.trace().quiet():  # a result's memory, not a step's intermediate
        for coord in np.ndindex(*grid.shape):
            dev = sharding.mesh.devices[coord]
            key = (sharding.block_index(coord, len(shape)), str(dev))
            if key not in made:
                made[key] = torch.zeros(bshape, dtype=dtype, device=dev)
            grid[coord] = made[key]
    out = Blocks(sharding, shape, grid)
    C.trace().place(out)
    return out


def placed_cache(make_specs, mesh) -> dict:
    """A zero decode cache placed by ``cache_shardings`` (``placed_zeros``
    per leaf) of the specs ``make_specs()`` returns: meta tensors, made
    outside a counting pass (shapes, not memory of the step)."""
    with C.trace().quiet():
        specs = make_specs()
    return tree_map(lambda t, sh: placed_zeros(sh, t.shape, t.dtype), specs,
                    cache_shardings(specs, mesh))


def _overlap(box: list, origin: tuple, size: tuple):
    """(slices into the block, slices into the source) where the block's
    ``box`` meets the region [origin, origin + size), or None."""
    blk, src = [], []
    for (lo, hi), o, n in zip(box, origin, size):
        a, b = max(lo, o), min(hi, o + n)
        if a >= b:
            return None
        blk.append(slice(a - lo, b - lo))
        src.append(slice(a - o, b - o))
    return tuple(blk), tuple(src)


def write_box(blocks: Blocks, src: torch.Tensor, origin: tuple) -> None:
    """``full[origin:origin + src.shape] = src`` on a placed tensor, in
    place: each distinct block takes the part of the region it holds (each
    rank keeps its slice of a value every rank has: no collective)."""
    for coord, t in blocks.distinct():
        hit = _overlap(blocks.box(coord), origin, tuple(src.shape))
        if hit is not None:
            t[hit[0]] = src[hit[1]].to(device=t.device, dtype=t.dtype)


def read_box(blocks: Blocks, origin: tuple, size: tuple, home, *,
             record: bool = True) -> torch.Tensor:
    """``full[origin:origin + size]`` of a placed tensor on ``home``. When
    one block on ``home`` holds the whole region it is a view of that block
    (a local slice); else the region is assembled from the blocks that hold
    it, each block index once: an all-gather of it (recorded unless
    ``record`` is off) when more than one block contributes."""
    size, nd = tuple(size), len(blocks.shape)
    hits, seen = [], set()
    for coord, t in blocks.distinct():
        idx = blocks.sharding.block_index(coord, nd)
        hit = _overlap(blocks.box(coord), origin, size)
        if hit is not None and idx not in seen:
            seen.add(idx)
            hits.append((t, *hit))
    home = torch.device(home)
    if len(hits) == 1 and tuple(hits[0][0][hits[0][1]].shape) == size \
            and hits[0][0].device == home:
        return hits[0][0][hits[0][1]]
    out = torch.empty(size, dtype=blocks.dtype, device=home)
    for t, blk, src in hits:
        out[src] = t[blk].to(home)
    if record and len(hits) > 1:
        blocks.sharding.mesh.record("all-gather", out.numel() * out.element_size())
    return out


def param_shardings(params, mesh, mode: str = "tp"):
    if mode == "fsdp":
        return tree_map_with_path(
            lambda path, leaf: NamedSharding(mesh, param_spec_fsdp(path, leaf, mesh), "fsdp"),
            params)
    if mode != "tp":
        raise ValueError(f"unknown parameter sharding mode {mode!r}")
    return tree_map_with_path(lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf)),
                              params)


def cache_shardings(cache, mesh, *, shard_seq: bool = False):
    """Decode-cache shardings.

    KV tensors (L, B, S, H, d): batch over the data axes when divisible;
    the cache SEQUENCE is sharded over "model" (flash-decoding style — each
    model shard owns a KV slice and attention combines partial softmax
    stats), which works for every kv-head count. ``shard_seq``
    (long-context, batch=1) spreads the sequence over ALL axes. State caches
    (SSM/xLSTM) shard batch only.
    """
    dp = _dp_axes(mesh)
    dp_axes = dp if isinstance(dp, tuple) else (dp,)
    dp_total = 1
    for a in dp_axes:
        dp_total *= mesh.shape[a]
    model = mesh.shape.get("model", 1)

    def spec_for(path, leaf):
        nd = leaf.ndim
        s = _path_str(path)
        if re.search(r"k_scale$|v_scale$", s) and nd == 4:
            L, B, S, H = leaf.shape
            if B % dp_total == 0 and S % model == 0:
                return NamedSharding(mesh, P(None, dp, "model", None))
            return NamedSharding(mesh, P(*([None] * nd)))
        if re.search(r"/k$|/v$|/ck$|/cv$", "/" + s) and nd == 5:
            L, B, S, H, hd = leaf.shape
            batch_ok = B % dp_total == 0
            if shard_seq or not batch_ok:
                seq_axes = tuple(dp_axes) + ("model",)
                total = dp_total * model
                if S % total == 0:
                    return NamedSharding(mesh, P(None, None, seq_axes, None, None))
                if S % model == 0:
                    return NamedSharding(mesh, P(None, None, "model", None, None))
                return NamedSharding(mesh, P(*([None] * nd)))
            if S % model == 0:
                return NamedSharding(mesh, P(None, dp, "model", None, None))
            return NamedSharding(mesh, P(None, dp, None, None, None))
        # ssm / lstm state tensors: find the batch-sized axis and shard it
        # over data when divisible (batch follows the layer-stack axes)
        spec = [None] * nd
        if nd >= 3:
            for ax in range(1, nd - 1):
                if leaf.shape[ax] % dp_total == 0 and leaf.shape[ax] >= dp_total:
                    spec[ax] = dp
                    break
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(spec_for, cache)


def shard_tree(tree, shardings):
    """Each leaf of ``tree`` placed by its sharding in ``shardings``."""
    return tree_map(lambda x, s: s.shard(x), tree, shardings)


def gather_tree(tree):
    """Each ``Blocks`` leaf of ``tree`` gathered to a full tensor on its
    mesh's home."""
    return tree_map(lambda b: b.gather(), tree)


@dataclass(frozen=True)
class RowSharding:
    """Rows split into equal contiguous blocks over ``mesh.shape[axis]``:
    the serving layout, ``NamedSharding(mesh, P(axis, None))`` with rank r's
    block kept on the device of rank r along ``axis`` (rank 0 of the other
    axes; the reference replicates each shard over them, which changes no
    result)."""

    mesh: object
    axis: str = "data"

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def devices(self) -> list[torch.device]:
        return [self.mesh.device_at(self.axis, r) for r in range(self.n_shards)]

    def shard(self, x) -> list[torch.Tensor]:
        """Per-rank row blocks of ``x`` (a tensor or a host array), each on
        its rank's device. Rows are zero-padded to a multiple of the shard
        count first (a copy, only when they do not divide); callers mask the
        padding through their ``valid_n``. Where every rank shares the
        tensor's device the blocks are views of it: no extra bytes."""
        devs = self.devices()
        if not isinstance(x, torch.Tensor):  # one upload when one device holds all
            x = torch.as_tensor(np.ascontiguousarray(x),
                                device=devs[0] if len(set(devs)) == 1 else "cpu")
        S = len(devs)
        pad = _round_up(x.shape[0], S) - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        n_local = x.shape[0] // S
        return [x[r * n_local:(r + 1) * n_local].to(d) for r, d in enumerate(devs)]


def row_sharding(mesh, axis: str = "data") -> RowSharding:
    """Row-sharded (N, d) placement for database matrices: the layout the
    serving column store and the distributed tournament scan agree on."""
    return RowSharding(mesh, axis)
