"""Explicit model parallelism on the single-controller mesh: what GSPMD
derives from the reference's shardings, written out.

The sharded model path (``models.model.train_loss`` under ``use_mesh`` with
parameters placed by ``param_shardings``) computes per rank with a
``ShardCtx``:

- data parallelism: the batch is split over the data axes (all of the mesh's
  axes but ``model``, flattened to ``n_dp`` data ranks, the first axis
  major); each data rank runs its rows;
- tensor parallelism (``mode="tp"``): the ``n_tp = mesh.shape["model"]``
  ranks of a data rank hold column blocks of the up projections (of
  ``wq`` / ``wk`` / ``wv``, d_ff of the MLP and of every expert) and row
  blocks of the down projections; attention's q heads split by
  ``head_range`` (ceil(Hq / n) a rank, none past the last: GSPMD's padded
  layout), each rank reading the kv heads its q heads read (``kv_heads_for``,
  straddled groups included) and attending once per uniform group
  (``attn_calls``), its ``wq`` columns and ``wo`` rows outside its own block
  moved by ``take``; a row-parallel product ends in a
  ``psum`` over ``model`` (``row_end``) or, with sequence parallelism, a
  reduce-scatter over the sequence, whose residual stream an all-gather
  joins again before the next column-parallel product (``seq_full``); the
  Mamba-2 and mLSTM blocks split by head (``head_range``: a rank owns
  contiguous heads and multiplies only by the columns they read, those in
  a neighbour's block moved by ``take``), the sLSTM by batch row;
- FSDP (``mode="fsdp"``): each data rank gathers a layer's weights whole
  before it uses them (recorded all-gathers) and computes as one device.

Activations are per-rank ``Act``s (``distributed.sharding``): per data rank
one tensor (the same on each of its model ranks, which the controller
computes once) or a tuple of the model ranks' sequence blocks.

Collectives go through ``distributed.collectives`` and are recorded in
``mesh.log`` once per op of the per-device program (the reference's unit:
an op that every data rank's group runs at once is one op of each device's
program), so the log reads like the reference's ``collective_bytes`` of its
compiled step.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import Act, Blocks, sequence_parallel, tree_map

_STATE = threading.local()


class ShardCtx:
    """The ranks of one sharded computation: ``n_dp`` data ranks (the
    non-``model`` axes flattened) x ``mesh.shape["model"]`` model ranks;
    ``n_tp`` of those compute a tensor-parallel product (1 in fsdp mode).
    With ``split_data`` off the batch is not split over the data ranks (a
    batch they do not divide, as serving's batch of 1): every data rank
    computes the same, so the controller computes it once, as data rank 0
    (``n_dp`` is 1; ``n_dp_mesh`` keeps the mesh's count)."""

    def __init__(self, mesh, mode: str = "tp", split_data: bool = True):
        names = tuple(mesh.axis_names)
        if "model" in names and names[-1] != "model":
            raise ValueError(f"the model axis must be the mesh's last: {names}")
        if mode not in ("tp", "fsdp"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        self.mesh, self.mode = mesh, mode
        self.n_model = int(mesh.shape.get("model", 1))
        dp = tuple(a for a in names if a != "model")
        self.dp_axis = dp[0] if len(dp) == 1 else dp
        self.n_dp_mesh = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
        self.n_dp = self.n_dp_mesh if split_data else 1
        self.grid = mesh.devices.reshape(self.n_dp_mesh, self.n_model)
        self.n_tp = self.n_model if mode == "tp" else 1
        self.sp = sequence_parallel() and self.n_tp > 1
        self.mirror = getattr(_STATE, "mirror", False)  # see ``each``
        if self.mirror and any(dev.type != "meta" for dev in mesh.devices.flat):
            raise ValueError("mirrored() computes data rank 0's part only: a mesh of "
                             "meta devices, never one of values")

    @staticmethod
    def for_params(mesh, params, split_data: bool = True) -> "ShardCtx":
        """The context of a parameter tree placed by ``param_shardings``
        (its mode read off the embedding's sharding)."""
        return ShardCtx(mesh, params["embed"].sharding.mode, split_data)

    def each(self, fn) -> list:
        """``[fn(d) for d in range(n_dp)]`` over the data ranks. With
        ``mirror`` on (a dry-run on ``meta`` tensors, where each data rank's
        part has data rank 0's shapes) it runs ``fn(0)`` only and gives the
        other data ranks aliases of its result, marked as theirs for the
        counting pass: the same collectives, shapes and rank-0 count, at
        1 / n_dp of the controller's work."""
        if not self.mirror or self.n_dp == 1:
            return [fn(d) for d in range(self.n_dp)]
        first = fn(0)
        return [first] + [_alias(first, d) for d in range(1, self.n_dp)]

    def dev(self, d: int, m: int = 0) -> torch.device:
        return self.grid[d, m]

    def to_rank(self, t: torch.Tensor, d: int, m: int | None = None) -> torch.Tensor:
        """``t`` on rank (d, m)'s device (data rank d's own with ``m`` None),
        as a copy the controller made for that rank alone: what a counting
        pass attributes to it."""
        return C.trace().rank(t.to(self.dev(d, m or 0)), d=d, m=m)

    def devs(self, d: int) -> list:
        return [self.grid[d, m] for m in range(self.n_tp)]

    # ---- parameters ----------------------------------------------------

    def _grid2(self, leaf: Blocks) -> np.ndarray:
        return leaf.grid.reshape(self.n_dp_mesh, self.n_model)

    def local(self, leaf: Blocks, d: int) -> list:
        """What each compute rank of data rank ``d`` multiplies with: in tp
        mode its own block (one per model rank), in fsdp mode the whole
        tensor gathered."""
        if self.mode == "tp":
            g = self._grid2(leaf)
            return [g[d, m] for m in range(self.n_model)]
        return [self.full(leaf, d)]

    def full(self, leaf: Blocks, d: int) -> torch.Tensor:
        """Data rank ``d``'s whole copy of ``leaf`` on its device: its own
        block when nothing is split, else the blocks gathered (its own data
        row's first; one recorded all-gather of the whole tensor)."""
        sh = leaf.sharding
        if not sh.split(leaf.ndim):
            return self._grid2(leaf)[d, 0]
        rows = np.arange(self.n_dp_mesh * self.n_model).reshape(self.n_dp_mesh, self.n_model)
        order = [np.unravel_index(i, leaf.grid.shape) for i in
                 list(rows[d]) + [i for r in range(self.n_dp_mesh) if r != d for i in rows[r]]]
        out = sh.gather(leaf, self.dev(d), first=order)
        out = C.trace().rank(out, d=d)
        if d == 0:
            self.mesh.record("all-gather", out.numel() * out.element_size())
        return out

    def view(self, tree, d: int):
        """``local`` of every leaf: a tree of per-compute-rank lists."""
        return tree_map(lambda b: self.local(b, d), tree)

    def full_view(self, tree, d: int):
        """``full`` of every leaf: data rank d's whole weights."""
        return tree_map(lambda b: self.full(b, d), tree)

    def gather_model(self, blocks: list, d: int, dim: int, size: int) -> torch.Tensor:
        """The model ranks' blocks of a column- or row-split weight joined
        along ``dim`` (cut to ``size``) on data rank d's device."""
        out = C.all_gather_dim(list(blocks), self.mesh, "model", dim, self.dev(d), size,
                               record=d == 0)
        return C.trace().rank(out, d=d)

    # ---- activations ---------------------------------------------------

    def rows(self, B: int, d: int) -> tuple[int, int]:
        """[start, stop) of data rank d's rows of a batch of ``B``."""
        b = B // self.n_dp
        return d * b, (d + 1) * b

    def split_batch(self, x: torch.Tensor) -> list:
        """Rows of ``x`` per data rank, each on its rank's device."""
        B = x.shape[0]
        if B % self.n_dp:
            raise ValueError(f"a batch of {B} rows does not split over {self.n_dp} data ranks")
        b = B // self.n_dp
        parts = [x[d * b:(d + 1) * b].to(self.dev(d)) for d in range(self.n_dp)]
        if self.n_dp > 1:
            C.trace().deliver(parts, [x], self.mesh, self.dp_axis, scattered=True)
        return parts

    def seq_full(self, xd, d: int) -> torch.Tensor:
        """Data rank d's whole (B, S, D) activation: sequence blocks are
        all-gathered over ``model`` (recorded)."""
        if isinstance(xd, tuple):
            return C.all_gather_dim(list(xd), self.mesh, "model", 1, self.dev(d),
                                    record=d == 0)
        return xd

    def seq_split(self, x: torch.Tensor, d: int):
        """Data rank d's activation cut into its model ranks' sequence
        blocks under sequence parallelism (each rank keeps its slice: no
        collective), when the sequence divides; else as it is."""
        if not self.sp or x.shape[1] % self.n_tp:
            return x
        s = x.shape[1] // self.n_tp
        return tuple(x[:, m * s:(m + 1) * s].to(self.dev(d, m)) for m in range(self.n_tp))

    def like(self, x: torch.Tensor, xd, d: int):
        """``x`` (whole) in the layout of ``xd``."""
        return self.seq_split(x, d) if isinstance(xd, tuple) else x

    def row_end(self, partials: list, d: int, split: bool):
        """The end of a row-parallel product: the model ranks' partial
        outputs summed (a psum over ``model``) or, when the residual stream
        is sequence-split, reduce-scattered over the sequence."""
        if len(partials) == 1:
            return self.seq_split(partials[0], d) if split else partials[0]
        if split:
            return tuple(C.reduce_scatter(partials, self.mesh, "model", 1, self.devs(d),
                                          record=d == 0))
        return C.psum(partials, self.mesh, "model", self.dev(d), record=d == 0)

    @staticmethod
    def rowwise(fn, xd, ws: list):
        """``fn(x, w)`` on each part of ``xd`` with the part's rank's ``w``."""
        if isinstance(xd, tuple):
            return tuple(fn(x, ws[m]) for m, x in enumerate(xd))
        return fn(xd, ws[0])

    @staticmethod
    def add(a, b):
        if isinstance(a, tuple):
            return tuple(x + y for x, y in zip(a, b))
        return a + b

    def psum_data(self, per_rank: list) -> torch.Tensor:
        """A psum over the data ranks, on data rank 0's device."""
        if len(per_rank) == 1:
            return per_rank[0]
        return C.psum(per_rank, self.mesh, self.dp_axis, self.dev(0))

    def gather_data(self, per_rank: list, dim: int, d: int = 0) -> torch.Tensor:
        """The data ranks' tensors joined along ``dim``: data rank ``d``'s
        copy of their all-gather over the data axes, on its device (the op
        recorded once, with data rank 0's copy)."""
        if len(per_rank) == 1:
            return per_rank[0]
        return C.all_gather_dim(per_rank, self.mesh, self.dp_axis, dim, self.dev(d),
                                record=d == 0)


def _alias(x, d: int):
    """``x`` (a tensor, or a tuple / list / dict of them) as data rank d's:
    data rank 0's result standing in for it, which only a meta tensor can
    (its values would be rank 0's)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise ValueError(f"a mirrored result on {x.device}: mirrored() is for meta "
                             f"tensors only")
        return C.trace().rank(x, d=d)
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_alias(v, d) for v in x)
    if isinstance(x, tuple):
        return type(x)(*(_alias(v, d) for v in x))
    if isinstance(x, dict):
        return {k: _alias(v, d) for k, v in x.items()}
    return x


@contextlib.contextmanager
def active(ctx: ShardCtx):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def current() -> ShardCtx | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def mirrored():
    """Every ``ShardCtx`` made inside computes data rank 0's part only and
    mirrors it to the other data ranks (``ShardCtx.each``): for a counting
    pass on ``meta`` tensors, never for values."""
    prev = getattr(_STATE, "mirror", False)
    _STATE.mirror = True
    try:
        yield
    finally:
        _STATE.mirror = prev


def lay_out(mesh, x: Act, layout: str) -> Act:
    """``shard_act`` of an ``Act``: ``btd`` (the residual stream between
    blocks) is cut into sequence blocks under sequence parallelism and
    joined otherwise; other layouts name the per-rank form the model code
    already computes in (``btv`` vocab-parallel logits, ``moe_ecd`` the
    capacity split, ``td`` tokens by data rank)."""
    if layout != "btd":
        return x
    ctx = current() or ShardCtx(mesh)
    parts = []
    for d, xd in enumerate(x.parts):
        if isinstance(xd, tuple) == ctx.sp:
            parts.append(xd)
        else:
            parts.append(ctx.seq_split(xd, d) if ctx.sp else ctx.seq_full(xd, d))
    return Act(parts)


# ---- vocab-parallel embedding, logits and loss --------------------------


class Vocab:
    """Data rank d's vocab-parallel view of the embedding: each compute rank
    holds ``Vb = ceil(V / n_tp)`` vocab rows (the last block zero-padded).
    ``embed`` is laid out (None, "model") — d_model split — by
    ``PARAM_RULES``, so an all-to-all over ``model`` turns it into vocab
    blocks; an untied ``lm_head`` (D, V) is vocab-split already."""

    def __init__(self, ctx: ShardCtx, params: dict, d: int):
        self.ctx, self.d = ctx, d
        emb = params["embed"]
        self.V, D = emb.shape
        if ctx.n_tp == 1:
            self.rows = [ctx.full(emb, d)]
        else:
            if tuple(emb.spec) != (None, "model"):
                raise ValueError(f"embed laid out {emb.spec}; tp mode expects (None, 'model')")
            rows = C.all_to_all(ctx.local(emb, d), ctx.mesh, "model", 0, 1, ctx.devs(d),
                                record=d == 0)
            # the d_model padding cut, if any
            self.rows = [C.trace().rank(r[:, :D], d=d) for r in rows]
        self.Vb = self.rows[0].shape[0]
        if "lm_head" in params:
            self.cols = ctx.local(params["lm_head"], d)
        else:
            self.cols = [r.T for r in self.rows]

    def lookup(self, tokens: torch.Tensor, split: bool, dtype):
        """Embedding rows of ``tokens`` (B, S) in ``dtype``: each rank looks
        up the ids in its vocab block (others give 0) and a psum over
        ``model`` (a reduce-scatter when ``split``) sums them; exact, as one
        rank holds each id, so the cast comes first (half the bytes of
        f32 rows)."""
        parts = []
        for m, w in enumerate(self.rows):
            ids = tokens.to(w.device) - m * self.Vb
            ok = (ids >= 0) & (ids < self.Vb)
            e = w[ids.clamp(0, self.Vb - 1)].to(dtype)
            parts.append(torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                    device=e.device)))
        return self.ctx.row_end(parts, self.d, split)

    def logits(self, h: torch.Tensor, cap: float) -> torch.Tensor:
        """Data rank d's logits (B, s, V) float32 of hidden states ``h``
        (B, s, D) on its device: each compute rank's vocab block,
        soft-capped, all-gathered over ``model`` (recorded) and cut to V."""
        from repro_torch.models.common import softcap
        blocks = [softcap(h.float().to(w.device) @ w.float(), cap) for w in self.cols]
        if len(blocks) == 1:
            return blocks[0]
        return C.all_gather_dim(blocks, self.ctx.mesh, "model", -1, self.ctx.dev(self.d),
                                self.V, record=self.d == 0)

    def logz_gold(self, h: torch.Tensor, targets: torch.Tensor, cap: float):
        """(logsumexp, gold logit) of data rank d's hidden states ``h``
        (B, s, D) against ``targets`` (B, s), for ``models.model.
        _xent_sums``: each rank computes its vocab block's logits (padded
        rows at -inf); the logsumexp comes from the psum of exp(logits -
        max) behind a pmax of the block maxima, the gold logit from a psum."""
        from repro_torch.models.common import softcap
        ctx, d = self.ctx, self.d
        if len(self.cols) == 1:
            logits = softcap(h.float() @ self.cols[0].float(), cap)
            return (torch.logsumexp(logits, dim=-1),
                    logits.gather(-1, targets[:, :, None])[..., 0])
        blocks, golds = [], []
        for m, w in enumerate(self.cols):
            lg = softcap(h.float().to(w.device) @ w.float(), cap)
            col = m * self.Vb + torch.arange(lg.shape[-1], device=lg.device)
            lg = torch.where(col < self.V, lg, float("-inf"))
            ids = targets.to(w.device) - m * self.Vb
            ok = (ids >= 0) & (ids < self.Vb)
            g = lg.gather(-1, ids.clamp(0, self.Vb - 1)[:, :, None])[..., 0]
            blocks.append(lg)
            golds.append(torch.where(ok, g, 0.0))
        rec = d == 0
        mx = C.pmax([b.amax(-1).detach() for b in blocks], ctx.mesh, "model", ctx.dev(d),
                    record=rec)
        se = C.psum([torch.exp(b - mx.to(b.device)[..., None]).sum(-1) for b in blocks],
                    ctx.mesh, "model", ctx.dev(d), record=rec)
        gold = C.psum(golds, ctx.mesh, "model", ctx.dev(d), record=rec)
        return mx + torch.log(se), gold


# ---- tensor-parallel attention -------------------------------------------


def head_range(H: int, n: int, m: int) -> tuple[int, int]:
    """[first, stop) of the heads model rank ``m`` owns of ``H`` over ``n``
    ranks: a contiguous ceil(H / n) each, so the ranks past the last head
    own none (xlstm's 4 mLSTM heads over 16 model ranks: ranks 4-15)."""
    c = -(-H // n)
    first = min(m * c, H)
    return first, min(first + c, H)


def block_ranges(N: int, n: int) -> list[list[tuple[int, int]]]:
    """Per rank, the [lo, hi) of a dim of ``N`` that its block holds when
    ``NamedSharding`` splits the dim over ``n`` ranks (ceil-sized blocks,
    the padding cut; none past the end)."""
    b = -(-N // n)
    return [[(r * b, min((r + 1) * b, N))] if r * b < N else [] for r in range(n)]


def _holder(have: list, at: int, prefer: int) -> tuple[int, int, int]:
    """(rank, offset in its part, end of its range) of the rank holding
    index ``at`` of the dim: ``prefer`` when it does, else the first."""
    for r in [prefer] + [r for r in range(len(have)) if r != prefer]:
        off = 0
        for lo, hi in have[r]:
            if lo <= at < hi:
                return r, off + at - lo, hi
            off += hi - lo
    raise IndexError(f"no rank holds index {at}")


def take(ctx: ShardCtx, parts: list, d: int, dim: int, have: list, want: list) -> list:
    """Model rank m's ranges ``want[m]`` (a list of [lo, hi) of one dim, in
    that order) of a tensor whose ranks hold the ranges ``have[r]`` of it
    (``parts[r]``, their ranges joined along ``dim``): per rank the pieces
    joined on its device, None where it wants nothing. A piece comes from
    the rank's own part where it holds it, else from the first rank that
    does: the columns a rank's heads need from a neighbour's block, of a
    weight or of a product. One recorded op when any piece moves: an
    all-gather (the whole result's bytes) when every rank that wants
    anything wants the same, else a collective-permute (the most bytes one
    rank receives)."""
    outs, moved = [], []
    with C.trace().quiet():
        for m, ranges in enumerate(want):
            if not ranges:
                outs.append(None)
                moved.append(0)
                continue
            dev, pieces, got = ctx.dev(d, m), [], 0
            for lo, hi in ranges:
                at = lo
                while at < hi:
                    r, off, end = _holder(have, at, m)
                    end = min(end, hi)
                    t = parts[r].narrow(dim, off, end - at)
                    if r != m:
                        got += t.numel() * t.element_size()
                    pieces.append(t.to(dev))
                    at = end
            outs.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim))
            moved.append(got)
    if d == 0 and any(moved):
        wanted = [tuple(w) for w in want if w]
        if len(set(wanted)) == 1:
            first = next(o for o in outs if o is not None)
            ctx.mesh.record("all-gather", first.numel() * first.element_size())
        else:
            ctx.mesh.record("collective-permute", max(moved))
    return [None if o is None else C.trace().rank(o, d=d, m=m) for m, o in enumerate(outs)]


def _foreign(have: list, want: list) -> list[int]:
    """Per rank, how many indices of ``want[m]`` its own ``have[m]`` lacks."""
    out = []
    for mine, ranges in zip(have, want):
        n = sum(hi - lo for lo, hi in ranges)
        for lo, hi in ranges:
            for a, b in mine:
                n -= max(0, min(hi, b) - max(lo, a))
        out.append(n)
    return out


def col_product(ctx: ShardCtx, x: torch.Tensor, blocks: list, N: int, d: int,
                want: list) -> list:
    """Per model rank m, ``x @ W[:, want[m]]`` (None where it wants
    nothing) for a column-split weight W of ``N`` columns whose per-rank
    blocks are ``blocks``; ``x`` (..., K) is data rank d's, which every
    model rank holds. Columns outside a rank's own block reach it one of two
    ways, both what GSPMD's reshard does: as products (every rank multiplies
    by its own block, then ``take`` moves the columns: tokens x columns)
    or as weights (``take`` moves the weight's columns first: K x columns),
    whichever moves fewer bytes to a rank (a decode step's few tokens move
    products, a long sequence moves weights)."""
    n = len(blocks)
    have = block_ranges(N, n)
    extra = max(_foreign(have, want))
    tokens = x.numel() // x.shape[-1]
    by_weights = extra * x.shape[-1] < extra * tokens
    ws = [w.to(x.dtype) for w in blocks]
    if by_weights:
        cols = take(ctx, ws, d, -1, have, want)
        return [None if w is None else x.to(w.device) @ w for w in cols]
    needed = {r for r in range(n) if any(_foreign([have[r]], [ranges])[0] <
                                         sum(hi - lo for lo, hi in ranges) for ranges in want)}
    prods = [x.to(ws[r].device) @ ws[r][..., :have[r][0][1] - have[r][0][0]] if r in needed
             else None for r in range(n)]
    return take(ctx, prods, d, -1, [h if r in needed else [] for r, h in enumerate(have)],
                want)


def col_gather(ctx: ShardCtx, x: torch.Tensor, blocks: list, N: int, d: int, lo: int,
               hi: int) -> torch.Tensor:
    """``x @ W[:, lo:hi]`` on every model rank of data rank d (a replicated
    activation: one tensor on its device) for a column-split weight W of
    ``N`` columns: one recorded all-gather over ``model``, of the blocks'
    products (tokens x (hi - lo)) or of the weight's columns (K x (hi -
    lo), then one product every rank computes), whichever is fewer bytes."""
    n = len(blocks)
    ws = [w.to(x.dtype) for w in blocks]
    if n == 1:
        return x @ ws[0][..., lo:hi]
    have = block_ranges(N, n)
    tokens = x.numel() // x.shape[-1]
    by_weights = x.shape[-1] < tokens

    def piece(r):
        a, b = (max(lo, have[r][0][0]), min(hi, have[r][0][1])) if have[r] else (0, 0)
        if b <= a:
            shape = ws[r].shape[:-1] if by_weights else x.shape[:-1]
            return torch.empty((*shape, 0), dtype=x.dtype, device=ws[r].device)
        w = ws[r][..., a - have[r][0][0]:b - have[r][0][0]]
        return w if by_weights else x.to(w.device) @ w
    out = C.all_gather_dim([piece(r) for r in range(n)], ctx.mesh, "model", -1, ctx.dev(d),
                           record=d == 0)
    return x @ out if by_weights else out


def row_product(ctx: ShardCtx, ys: list, have: list, blocks: list, N: int, d: int,
                split: bool):
    """``y @ W`` for a row-split weight W of ``N`` rows (per-rank blocks
    ``blocks``) and an activation y whose model ranks hold its columns
    ``have[m]`` (``ys[m]``, None where a rank holds none), ending in
    ``row_end``. Where a rank's columns are not its block's rows, either
    its weight rows move to it, or the activation's columns move to the
    rows' owners (``take``): whichever moves fewer bytes to a rank."""
    n = len(blocks)
    rows = block_ranges(N, n)
    y0 = next(y for y in ys if y is not None)
    tokens = y0.numel() // y0.shape[-1]
    ws = [w.to(y0.dtype) for w in blocks]
    if max(_foreign(rows, have)) * ws[0].shape[-1] <= max(_foreign(have, rows)) * tokens:
        mine = take(ctx, ws, d, 0, rows, have)
        parts = [None if y is None else y @ w for y, w in zip(ys, mine)]
    else:
        yb = take(ctx, ys, d, -1, have, rows)
        parts = [None if y is None else y @ w[:y.shape[-1]] for y, w in zip(yb, ws)]
    return ctx.row_end(parts, d, split)


def split_rms_norm(ctx: ShardCtx, ys: list, scales: list, N: int, d: int,
                   eps: float = 1e-6) -> list:
    """``models.common.rms_norm`` over a dim of ``N`` whose model ranks hold
    pieces ``ys[m]`` (None: none) with their slices ``scales[m]`` of the
    scale: the mean square from a psum of each rank's sums of squares,
    shaped (..., 1)."""
    sq = [None if y is None else (y.float() * y.float()).sum(-1, keepdim=True) for y in ys]
    live = [t for t in sq if t is not None]
    total = live[0] if len(live) == 1 else C.psum(sq, ctx.mesh, "model", ctx.dev(d),
                                                  record=d == 0)
    var = total / N
    return [None if y is None else
            (y.float() * torch.rsqrt(var.to(y.device) + eps) * (1.0 + s.float())).to(y.dtype)
            for y, s in zip(ys, scales)]


class Batch(NamedTuple):
    """What a data rank's model ranks compute next, for ``each_grouped``:
    ``fn(*args[m])`` for each model rank m in ``args``, joined and cut as
    ``grouped`` says."""
    args: dict
    cat: tuple
    rows: tuple
    fn: object
    out: tuple
    counts: dict


def grouped(ctx: ShardCtx, args: dict, cat: tuple, rows: tuple, fn, out: tuple,
            counts: dict) -> dict:
    """``fn(*args[(d, m)])`` for each rank (d, m) in ``args``, as the
    controller runs it: the ranks that share a device (a debug mesh)
    compute as one batch. Each model rank's data ranks join along dim 0
    where ``rows`` marks an argument as the data rank's rows (else the
    first's is taken), then the model ranks along ``cat`` (an entry None:
    the same for every model rank, the first's taken; a non-tensor passes
    as it is); the results are cut back along ``out``'s (dim, unit) entries,
    ``counts[m]`` units a model rank (times its data ranks along dim 0),
    then along dim 0 into the data ranks' rows. A counting pass keeps rank
    (0, 0) apart, so its count stays rank 0's. Returns {(d, m): results}."""
    groups: dict = {}
    for d, m in args:
        key = "rank0" if ctx.mirror and (d, m) == (0, 0) else str(ctx.dev(d, m))
        groups.setdefault(key, []).append((d, m))
    res = {}
    for keys in groups.values():
        ds, ms = sorted({d for d, _ in keys}), sorted({m for _, m in keys})
        if len(keys) != len(ds) * len(ms):
            raise ValueError(f"ranks {keys} sharing a device are not a grid")

        def of(m, i):  # argument i of model rank m, its data ranks' rows joined
            parts = [args[(d, m)][i] for d in (ds if rows[i] else ds[:1])]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        first = args[keys[0]]
        joined = []
        for i, dim in enumerate(cat):
            if not isinstance(first[i], torch.Tensor):
                joined.append(first[i])
                continue
            t = of(ms[0], i) if dim is None or len(ms) == 1 else \
                torch.cat([of(m, i) for m in ms], dim)
            joined.append(C.trace().rank(t, d=ds[0], m=ms[0]))
        outs = fn(*joined)
        for o, (dim, unit) in zip(outs, out):
            by_m = torch.split(o, [counts[m] * unit * (len(ds) if dim == 0 else 1)
                                   for m in ms], dim)
            for m, part in zip(ms, by_m):
                for d, t in zip(ds, part.chunk(len(ds))):
                    res.setdefault((d, m), []).append(C.trace().rank(t, d=d, m=m))
    return {key: tuple(v) for key, v in res.items()}


def each_grouped(ctx: ShardCtx, run) -> list:
    """``ctx.each(run)`` for a generator function ``run(d)``: each data
    rank's generator runs to its next yield, a ``Batch`` of its model
    ranks' calls; the calls of every (data, model) rank are computed
    together (``grouped``) and each generator gets {m: results} back,
    until they return (what ``each`` returns). A debug mesh then runs one
    batched call where its ranks would run one each."""
    ds = [0] if ctx.mirror else list(range(ctx.n_dp))
    gens, sent, results = {d: run(d) for d in ds}, dict.fromkeys(ds), {}
    while gens:
        asks = {}
        for d in list(gens):
            try:
                asks[d] = gens[d].send(sent[d])
            except StopIteration as stop:
                results[d] = stop.value
                del gens[d]
        if asks and gens.keys() != asks.keys():
            raise RuntimeError("data ranks out of step")
        if asks:
            b = next(iter(asks.values()))
            done = grouped(ctx, {(d, m): a for d, ask in asks.items() for m, a in
                                 ask.args.items()}, b.cat, b.rows, b.fn, b.out, b.counts)
            sent = {d: {m: done[(d, m)] for m in ask.args} for d, ask in asks.items()}
    out = [results[d] for d in ds]
    return out + [_alias(out[0], d) for d in range(len(ds), ctx.n_dp)]


def kv_heads_for(m: int, n_tp: int, Hq: int, Hkv: int) -> tuple[int, int]:
    """(first, count) of the kv heads that model rank ``m``'s q heads
    (``head_range``) read, GQA groups of Hq / Hkv: every group its heads
    touch, two or more where they straddle groups (qwen2-7b's 28 q heads on
    8 ranks: rank 1's heads 4-7 read kv heads 0 and 1); (0, 0) for a rank
    that owns no q head."""
    a, b = head_range(Hq, n_tp, m)
    if b == a:
        return 0, 0
    G = Hq // Hkv
    return a // G, (b - 1) // G - a // G + 1


def q_runs(m: int, n_tp: int, Hq: int, Hkv: int) -> list[tuple[int, int, int]]:
    """Model rank ``m``'s q heads cut into runs that each read one kv head:
    (first q head, stop, kv head) in order, none for a rank without heads
    (qwen2-7b's 28 / 4 heads on 8 ranks, rank 1: (4, 7, 0), (7, 8, 1))."""
    a, b = head_range(Hq, n_tp, m)
    G = Hq // Hkv
    return [(max(a, j * G), min(b, (j + 1) * G), j) for j in range(a // G, -(-b // G))
            if b > a]


def attn_calls(m: int, n_tp: int, Hq: int, Hkv: int) -> list[tuple[slice, slice]]:
    """The flash calls of model rank ``m``'s attention: (its q heads, its kv
    heads), each relative to the rank's first (``head_range``,
    ``kv_heads_for``), so that every call is a uniform GQA group (q head i
    of a call reads its kv head i // (q heads / kv heads)): one call when the
    rank's runs (``q_runs``) have one length, else one a run. No call for a
    rank without heads; k / v are sliced, never repeated per q head."""
    runs = q_runs(m, n_tp, Hq, Hkv)
    if not runs:
        return []
    a, first = runs[0][0], runs[0][2]
    if len({hi - lo for lo, hi, _ in runs}) == 1:
        return [(slice(0, runs[-1][1] - a), slice(0, len(runs)))]
    return [(slice(lo - a, hi - a), slice(j - first, j - first + 1)) for lo, hi, j in runs]


def per_call(attend, m: int, n_tp: int, Hq: int, Hkv: int, q: torch.Tensor, kv: tuple):
    """``attend(q, *kv)`` of model rank ``m``'s q heads (B, S, heads, hd) over
    its kv heads, one call per ``attn_calls`` entry: q's heads and those of
    each tensor of ``kv`` (k, v and an int8 cache's scales, heads at dim 2)
    sliced to the call's, the outputs joined by head."""
    outs = [attend(q[:, :, hq], *(t[:, :, hk] for t in kv))
            for hq, hk in attn_calls(m, n_tp, Hq, Hkv)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 2)

