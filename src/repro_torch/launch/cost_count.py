"""One counting pass over a step on ``meta`` tensors: the port's count of
what the reference reads from XLA's ``cost_analysis`` and
``memory_analysis`` of a compiled per-device program.

``CostCount`` is a ``TorchDispatchMode``: run the step inside it and every
aten op passes through it (nothing is computed on ``meta``; shapes only).
It counts, for ONE rank of the mesh (rank 0 of every axis, the reference's
per-device program):

- ``flops``: each op's flops by ``torch.utils.flop_counter``'s formulas
  (2 x M x N x K a product), and each flash-attention call by its own kept
  (q, k) pairs (``kernels/flash_attention: kept_pairs``, reported through
  ``meta_counters``: 4 x d a pair forward, 10 x d backward), not by a dense
  score matrix; elementwise ops count none;
- ``bytes``: the operands plus the results of every op that is not a view
  and has an operand (a fill of a new tensor counts none). Nothing is
  fused, so this is an upper bound of the traffic the step needs (XLA's
  "bytes accessed" is of its fused program);
- ``temp_peak``: the peak of the live bytes of the tensors the step's ops
  made (intermediates and the results it returns), rank 0's.

Which rank an op belongs to: the controller computes every rank's part in
turn, so each tensor carries a tag (data rank, model rank), ``None`` where
every rank of that axis holds it. Inputs placed on the mesh (``Blocks``)
are tagged by the ranks that hold each block (``tag_blocks``); an op's
result takes the tags its operands agree on; the collectives, the batch
split and the other per-rank copies say which ranks hold their results
(``distributed.collectives.trace``); an op whose operands' ranks disagree
is a collective's data movement, not compute. An op counts when its tag is
rank 0's or ``None``: work every rank does alike (what the controller
computes once for a data rank's model ranks) counts once, as in a
per-device program.
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import Blocks, leaves_with_path
from repro_torch.kernels.flash_attention import kernel as FK

_TAG = "_mint_rank"


def _tag(t: torch.Tensor) -> tuple:
    return getattr(t, _TAG, (None, None))


def _merge(tags: list) -> tuple[tuple, bool]:
    """(the tag the operands agree on, whether any coordinate disagrees)."""
    out, clash = [None, None], False
    for k in range(2):
        vals = {t[k] for t in tags if t[k] is not None}
        if len(vals) == 1:
            out[k] = vals.pop()
        elif vals:
            clash = True
    return tuple(out), clash


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _key(x):
    """A hashable key of an op's arguments: tensors by (shape, stride,
    dtype), containers element by element, everything else itself."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    hash(x)
    return x


def _metas(out):
    """The (shape, stride, dtype) of a result tensor or tuple of tensors;
    None for anything else."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out and all(isinstance(t, torch.Tensor) for t in out):
        return [(tuple(t.shape), t.stride(), t.dtype) for t in out]
    return None


def _build(hit):
    if isinstance(hit, list):
        return tuple(torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in hit)
    s, st, dt = hit
    return torch.empty_strided(s, st, dtype=dt, device="meta")


def _written(func, args, kwargs):
    """The operands an in-place / out= op writes, in its returns' order
    (None when one cannot be matched)."""
    sets = {}
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            val = args[i] if i < len(args) else kwargs.get(a.name)
            for name in a.alias_info.before_set:
                sets[name] = val
    out = []
    for r in func._schema.returns:
        vals = [sets.get(name) for name in r.alias_info.before_set]
        if not vals or not isinstance(vals[0], torch.Tensor):
            return None
        out.append(vals[0])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


class CostCount(TorchDispatchMode):
    """The counting pass. ``with CostCount(mesh) as cc: step(...)``; then
    ``cc.record()``. ``mesh`` None: one device (every op counts)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.n_model = 1 if mesh is None else int(mesh.shape.get("model", 1))
        self.flops = 0
        self.flash_flops = 0
        self.flash_calls = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._quiet = 0
        self._storages: dict = {}  # storage id -> [live tensors, bytes]
        self._meta_cache: dict = {}

    # ---- the hooks of distributed.collectives.trace() --------------------

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _axes(self, mesh, axis) -> tuple[bool, bool]:
        """(the axis spans data ranks, it spans model ranks)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        return any(a != "model" for a in axes), "model" in axes

    def deliver(self, outs, ins, mesh, axis, scattered: bool = False) -> None:
        (d, m), _ = _merge([_tag(t) for t in ins])
        data, model = self._axes(mesh, axis)
        for r, t in enumerate(outs):
            dd, mm = (None if data else d), (None if model else m)
            if scattered:
                if data and model:
                    dd, mm = divmod(r, self.n_model)
                elif model:
                    mm = r
                else:
                    dd = r
            self._set(t, (dd, mm))

    def place(self, blocks: Blocks) -> None:
        tag_blocks(blocks, self)

    def rank(self, t: torch.Tensor, d=None, m=None) -> torch.Tensor:
        old = _tag(t)
        alias = t.view_as(t)
        self._set(alias, (old[0] if d is None else d, old[1] if m is None else m))
        return alias

    # ---- counting ------------------------------------------------------

    @staticmethod
    def _mine(tag: tuple) -> bool:
        return tag[0] in (None, 0) and tag[1] in (None, 0)

    def _set(self, t: torch.Tensor, tag: tuple) -> None:
        setattr(t, _TAG, tag)
        if not self._mine(tag):
            key = t.untyped_storage()._cdata
            ent = self._storages.pop(key, None)
            if ent is not None:
                self.live -= ent[1]

    def _release(self, key: int) -> None:
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] <= 0:
            self.live -= ent[1]
            del self._storages[key]

    def _track(self, outs: list, ins: list) -> None:
        """Adds the new storages among ``outs`` to the live bytes (a view of
        a tracked storage keeps it alive)."""
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            ent = self._storages.get(key)
            if ent is None:
                if key in in_keys:
                    continue  # a view or in-place result of an untracked tensor
                ent = self._storages[key] = [0, int(t.untyped_storage().nbytes())]
                self.live += ent[1]
                self.peak = max(self.peak, self.live)
            ent[0] += 1
            weakref.finalize(t, self._release, key)

    def _count(self, ins: list, outs: list, flops: int, view: bool) -> None:
        self.ops += 1
        self.flops += int(flops)
        if ins and not view:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._track(outs, ins)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)`` on meta tensors, faster: a functional
        op's result metadata is cached by its operands' (shape, stride,
        dtype) and the other arguments, and a hit makes the result with
        ``empty_strided`` (many meta kernels are Python decompositions, and a
        mesh repeats each op once per rank); an in-place op returns the
        operand it writes without running its shape checks."""
        rets = func._schema.returns
        if rets and all(r.alias_info is None for r in rets):
            try:
                key = (func, _key(args), _key(kwargs))
            except TypeError:  # an argument that does not hash
                return func(*args, **kwargs)
            hit = self._meta_cache.get(key)
            if hit is None:
                out = func(*args, **kwargs)
                hit = _metas(out)
                if hit is not None:
                    self._meta_cache[key] = hit
                return out
            return _build(hit)
        if rets and all(r.alias_info is not None and r.alias_info.is_write for r in rets):
            written = _written(func, args, kwargs)
            if written is not None:
                return written[0] if len(rets) == 1 else tuple(written)
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        tag, clash = _merge([_tag(t) for t in ins])
        for t in outs:
            setattr(t, _TAG, tag)
        if self._quiet or clash or not self._mine(tag):
            return out
        packet = func.overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        self._count(ins, outs, flops, _is_view(func))
        return out

    def flash(self, name: str, ins: tuple, outs: tuple, flops: int) -> None:
        """A flash-attention call on meta tensors (``meta_counters``)."""
        tag, clash = _merge([_tag(t) for t in ins if t is not None])
        for t in outs:
            self._set(t, tag)
        if clash or not self._mine(tag):
            return
        self.flash_calls += 1
        self.flash_flops += int(flops)
        self.flops += int(flops)
        self.bytes += sum(_nbytes(t) for t in ins if t is not None) + sum(map(_nbytes, outs))

    def __enter__(self):
        self._hooks = contextlib.ExitStack()
        self._hooks.enter_context(C.tracing(self))
        FK.meta_counters().append(self.flash)
        self._hooks.callback(FK.meta_counters().remove, self.flash)
        return super().__enter__()

    def __exit__(self, *exc):
        self._hooks.close()
        return super().__exit__(*exc)

    def record(self) -> dict:
        """The pass's totals: what ``launch.roofline.extract_cost`` and
        ``extract_memory`` read."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "flash_flops": float(self.flash_flops), "flash_calls": self.flash_calls,
                "ops": self.ops, "temp_peak": int(self.peak)}


def tag_blocks(blocks: Blocks, cc: CostCount | None = None) -> None:
    """Tags each distinct block of ``blocks`` with the (data, model) rank
    that holds it (``None`` along an axis whose ranks share it)."""
    mesh = blocks.sharding.mesh
    n_model = int(mesh.shape.get("model", 1))
    held: dict = {}
    for coord in np.ndindex(*blocks.grid.shape):
        flat = int(np.ravel_multi_index(coord, blocks.grid.shape))
        held.setdefault(id(blocks.grid[coord]), (blocks.grid[coord], set(), set()))
        held[id(blocks.grid[coord])][1].add(flat // n_model)
        held[id(blocks.grid[coord])][2].add(flat % n_model)
    for t, ds, ms in held.values():
        tag = (ds.pop() if len(ds) == 1 else None, ms.pop() if len(ms) == 1 else None)
        if cc is None:
            setattr(t, _TAG, tag)
        else:
            cc._set(t, tag)


def tag_tree(tree) -> None:
    """``tag_blocks`` of every ``Blocks`` leaf of ``tree``."""
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, Blocks):
            tag_blocks(leaf)


def rank0_bytes(tree) -> int:
    """The bytes rank 0 of the mesh holds of ``tree``: each ``Blocks``
    leaf's block there (with its padding), each plain tensor whole."""
    total = 0
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, Blocks):
            total += _nbytes(leaf.grid.flat[0])
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total
