"""Model builder: init / prefill / decode_step for all ten registered
architectures, dispatched on ``ArchConfig.family`` as in
``repro.models.model``: dense (qwen2-7b, yi-9b, codeqwen1.5-7b, gemma2-27b),
moe (the granite-moe pair), vlm (qwen2-vl-2b: an M-RoPE vision prefix),
hybrid (zamba2-1.2b: groups of Mamba-2 layers, each followed by one shared
attention block with its own KV slot), ssm (xlstm-350m: super-blocks of
mLSTM layers and one sLSTM) and encdec (whisper-medium: an encoder over
stubbed frame embeddings, a decoder with cross attention).

Layer parameters are stacked along leading axes, leaf for leaf as in the
reference ((L, ...); zamba2's groups (G, n, ...), xlstm's super-blocks
(n_super, n_m, ...)), and each stack is a Python loop over its axes. Caches
are stacked the same way. Unlike the reference, whose arrays are
immutable, prefill and decode write the new k / v and recurrent states into
the cache they are given, in place, and return that same dict: a 27B
model's cache is gigabytes, and a copy per step would double it.

``train_loss`` is the reference's: the sequence-chunked cross entropy with
its z-loss over the shifted targets (qwen2-vl's vision prefix masked out),
plus 0.01 x the MoE's load-balancing loss. Under ``cfg.remat`` each block
(an attention + MLP layer, a Mamba-2 layer, an xLSTM super-block) is
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan bodies). On the card attention runs through
the flash kernel both ways (``kernels/flash_attention``: FlashAttentionFn).
Under ``use_mesh`` ``train_loss`` runs the sharded path at the end of this
module (``distributed.tensor_parallel``): the same function computed per
rank of the mesh, each rank's attention in the flash kernel on its heads
(``head_range``: ceil(Hq / n) a rank, none past the last, as GSPMD pads
them), its Mamba-2 and mLSTM blocks on its heads and its sLSTM on its batch
rows.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import kv_cache as KV
from repro_torch.distributed.sharding import (Act, Blocks, cache_shardings, current_mesh,
                                              gather_tree, param_shardings, placed_cache, read_box,
                                              shard_act, shard_tree, tree_map, use_mesh,
                                              write_box)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.common import apply_rope, dense_init, rms_norm, softcap

ACT_DTYPE = torch.bfloat16
NO_WINDOW = 1 << 30
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")


def _family(cfg: ArchConfig) -> str:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    return cfg.family


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def _init_attn(gen, cfg: ArchConfig, dtype, lead: tuple) -> dict:
    hd, Hq, Hkv, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    n = len(lead)
    p = {
        "wq": dense_init(gen, (*lead, D, Hq * hd), n, dtype),
        "wk": dense_init(gen, (*lead, D, Hkv * hd), n, dtype),
        "wv": dense_init(gen, (*lead, D, Hkv * hd), n, dtype),
        "wo": dense_init(gen, (*lead, Hq * hd, D), n, dtype),
    }
    if cfg.qkv_bias:
        zeros = dict(dtype=dtype, device=gen.device)
        p["bq"] = torch.zeros((*lead, Hq * hd), **zeros)
        p["bk"] = torch.zeros((*lead, Hkv * hd), **zeros)
        p["bv"] = torch.zeros((*lead, Hkv * hd), **zeros)
    return p


def _init_attn_mlp_layer(gen, cfg: ArchConfig, dtype, lead: tuple,
                         cross: bool = False) -> dict:
    """An attention (+ cross attention) + MLP or MoE layer, stacked along
    ``lead``."""
    D = cfg.d_model

    def zeros():
        return torch.zeros((*lead, D), dtype=dtype, device=gen.device)

    p = {"attn": _init_attn(gen, cfg, dtype, lead), "ln_attn": zeros(),
         "ln_mlp": zeros()}
    if cfg.sandwich_norm:
        p["ln_attn_post"] = zeros()
        p["ln_mlp_post"] = zeros()
    if cross:
        p["cross"] = _init_attn(gen, cfg, dtype, lead)
        p["ln_cross"] = zeros()
    if cfg.n_experts:
        p["moe"] = MOE.init_moe(gen, D, cfg.n_experts, cfg.expert_dff, cfg.moe_top_k,
                                dtype, layers=lead)
    elif cfg.d_ff:
        p["mlp"] = F.init_mlp(gen, D, cfg.d_ff, dtype, layers=lead)
    return p


def _init_mamba_layers(gen, cfg: ArchConfig, dtype, lead: tuple) -> dict:
    return {"m": SSM.init_mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                                 cfg.ssm_headdim, cfg.ssm_conv, dtype, layers=lead),
            "ln": torch.zeros((*lead, cfg.d_model), dtype=dtype, device=gen.device)}


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device=None) -> dict:
    """Random parameters of ``cfg`` from a generator seeded with ``seed`` on
    ``device`` (None: the card), drawn directly in ``dtype``: the tree and
    shapes of ``repro.models.model.init_params`` (whose draws differ: to run
    the reference's weights, carry them with ``convert.model_params_from_jax``).
    Norm scales start at 0 (rms_norm multiplies by 1 + scale).
    ``device="meta"`` gives the tree's shapes and dtypes only (the
    reference's ``jax.eval_shape`` of it), allocating nothing."""
    fam = _family(cfg)
    if device is not None and torch.device(device).type == "meta":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            fake = init_params(cfg, seed, dtype=dtype, device="cpu")
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, L = cfg.d_model, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: dict = {
        "embed": dense_init(gen, (cfg.vocab_size, D), 1, dtype),
        "ln_final": zeros(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.vocab_size), 0, dtype)
    if fam in ("dense", "moe", "vlm"):
        params["layers"] = _init_attn_mlp_layer(gen, cfg, dtype, (L,))
    elif fam == "hybrid":  # zamba2
        G = L // cfg.attn_every
        params["mamba_groups"] = _init_mamba_layers(gen, cfg, dtype, (G, cfg.attn_every))
        leftover = L - G * cfg.attn_every
        if leftover:
            params["mamba_tail"] = _init_mamba_layers(gen, cfg, dtype, (leftover,))
        params["shared_attn"] = _init_attn_mlp_layer(gen, cfg, dtype, ())
    elif fam == "ssm":  # xlstm
        n_super, n_m = L // cfg.slstm_every, cfg.slstm_every - 1
        params["super"] = {
            "mlstm": {"x": XL.init_mlstm(gen, D, cfg.n_heads, cfg.proj_factor, dtype,
                                         layers=(n_super, n_m)),
                      "ln": zeros(n_super, n_m, D)},
            "slstm": {"x": XL.init_slstm(gen, D, dtype, layers=(n_super,)),
                      "ln": zeros(n_super, D)},
        }
    else:  # encdec: whisper
        params["enc_layers"] = _init_attn_mlp_layer(gen, cfg, dtype, (cfg.n_enc_layers,))
        params["dec_layers"] = _init_attn_mlp_layer(gen, cfg, dtype, (L,), cross=True)
        params["ln_enc"] = zeros(D)
    return params


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and NamedTuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def param_count(params) -> int:
    return int(sum(x.numel() for _, x in _leaves(params)))


def active_param_count(cfg: ArchConfig, params) -> int:
    """MoE: router + active experts fraction; dense: everything."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    expert = sum(x.numel() for path, x in _leaves(params)
                 if "w_gate" in path or "w_down" in path)
    return int(total - expert * (1 - cfg.moe_top_k / cfg.n_experts))


def _layer(state, i: int):
    """Layer ``i`` of a stacked recurrent state (a NamedTuple of tensors):
    views into the leaves' leading axis, which the layer writes in place."""
    return type(state)(*(t[i] for t in state))


def _unstack(stacked) -> list:
    """The layers of a stacked parameter tree: a list of per-layer trees of
    views, from one ``torch.unbind`` per leaf, whose backward stacks the
    layers' gradients once (indexing a stack layer by layer would make each
    layer's backward a zero gradient the size of the whole stack)."""
    if isinstance(stacked, dict):
        per = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(stacked))


def _remat(cfg: ArchConfig, fn, x, *args):
    """fn(x, *args); under ``cfg.remat``, when a gradient is being taken
    through x, its activations are recomputed in the backward instead of
    kept (the reference's ``jax.checkpoint`` of a scan body)."""
    if cfg.remat and x.requires_grad and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


def _store(dst, src) -> None:
    """Copy a recurrent state (a NamedTuple of tensors) into its cache views."""
    for d, s in zip(dst, src):
        d.copy_(s)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _quantize_kv(t: torch.Tensor):
    """per-(token, head) symmetric int8: returns (int8 values, f32 scales)."""
    t32 = t.float()
    s = (t32.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(t32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _write(cache_t: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """cache_t[:, pos:pos + S] = new. The reference's dynamic_update_slice
    clamps a write that runs past the cache's end to its last S slots; the
    port raises instead of overwriting other positions."""
    S, max_len = new.shape[1], cache_t.shape[1]
    if pos < 0 or pos + S > max_len:
        raise ValueError(f"cache write at {pos}..{pos + S} runs past its "
                         f"{max_len} slots")
    cache_t[:, pos:pos + S] = new.to(cache_t.dtype)


def _attn(cfg: ArchConfig, p, x, positions, *, window, causal=True,
          kv_cache=None, pos=None, kv_override=None):
    """x: (B,S,D). kv_cache: (k, v[, k_scale, v_scale]) of (B,Smax,Hkv,hd),
    written at ``pos`` in place and then read (int8 + scales when
    quantized). kv_override: precomputed (k, v) (cross attention: no rope,
    not causal, every key)."""
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = _proj(x, p, "wq", "bq", Hq, hd)
    scales = {}
    if kv_override is not None:
        k, v = kv_override
        kv_len, q_offset, causal = k.shape[1], 0, False
    else:
        k = _rope(cfg, _proj(x, p, "wk", "bk", Hkv, hd), positions)
        v = _proj(x, p, "wv", "bv", Hkv, hd)
        q = _rope(cfg, q, positions)
        S = x.shape[1]
        if kv_cache is not None:
            if len(kv_cache) == 4 and kv_cache[2] is not None:  # int8 cache
                ck, cv, cks, cvs = kv_cache
                kq, ks_new = _quantize_kv(k)
                vq, vs_new = _quantize_kv(v)
                for cache_t, new in ((ck, kq), (cv, vq), (cks, ks_new), (cvs, vs_new)):
                    _write(cache_t, new, pos)
                scales = dict(k_scale=cks, v_scale=cvs)
            else:
                ck, cv = kv_cache[:2]
                _write(ck, k, pos)
                _write(cv, v, pos)
            k, v = ck, cv
            kv_len, q_offset = pos + S, pos
        else:
            kv_len, q_offset = S, 0
    if not scales:
        k, v = k.to(dt), v.to(dt)
    return _attend(cfg, q, k, v, p["wo"], causal=causal, window=window,
                   q_offset=q_offset, kv_len=kv_len, **scales)


def _proj(x, p, w: str, b, heads: int, hd: int) -> torch.Tensor:
    """``x @ p[w]`` (+ ``p[b]`` where the layer has that bias) in x's dtype,
    (B, S, heads, hd): a q, k or v projection, of one device's weights or
    of one tensor-parallel rank's columns."""
    y = x @ p[w].to(x.dtype)
    if b in p:
        y = y + p[b].to(x.dtype)
    return y.reshape(*x.shape[:2], heads, hd)


def _rope(cfg: ArchConfig, t: torch.Tensor, positions) -> torch.Tensor:
    return apply_rope(t, positions, cfg.rope_theta, cfg.mrope_sections)


def _attend(cfg: ArchConfig, q, k, v, wo, **kw) -> torch.Tensor:
    """q's attention over (k, v) (the flash kernel on the card), projected by
    ``wo``: one device's (a tensor-parallel rank's: ``_heads_attend`` and
    ``_wo_tp``)."""
    B, S = q.shape[:2]
    out = A.attention(q, k, v, softcap=cfg.attn_softcap, **kw)
    return out.reshape(B, S, -1) @ wo.to(q.dtype)


def _attn_mlp_block(cfg: ArchConfig, p, x, positions, *, window, kv_cache=None,
                    pos=None, causal=True, cross_kv=None):
    """Returns (x, aux): aux is the MoE's load-balancing loss (0 without)."""
    h = _attn(cfg, p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps),
              positions, window=window, causal=causal, kv_cache=kv_cache, pos=pos)
    if cfg.sandwich_norm:
        h = rms_norm(h, p["ln_attn_post"], cfg.norm_eps)
    x = x + h
    if "cross" in p:
        x = x + _attn(cfg, p["cross"], rms_norm(x, p["ln_cross"], cfg.norm_eps),
                      positions, window=window, kv_override=cross_kv)
    aux = 0.0
    h_in = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.n_experts:
        h, aux = MOE.moe(p["moe"], h_in, cfg.moe_top_k, cfg.moe_impl)
    else:
        h = F.mlp(p["mlp"], h_in, cfg.mlp_act)
    if cfg.sandwich_norm:
        h = rms_norm(h, p["ln_mlp_post"], cfg.norm_eps)
    return x + h, aux


def _layer_windows(cfg: ArchConfig, n: int) -> list[int]:
    """Per-layer attention window: gemma2 alternates local (even layers) and
    global; everyone else is global."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else NO_WINDOW for i in range(n)]
    return [NO_WINDOW] * n


def _block_at(x, p, cfg, positions, **kw):
    """``_attn_mlp_block`` with the hidden state first (``_remat``'s order)."""
    return _attn_mlp_block(cfg, p, x, positions, **kw)


def _run_layers(cfg: ArchConfig, stacked, x, positions, *, kv_cache=None,
                pos=None, causal=True, cross_kv=None):
    """The attn (+ cross) + mlp stack, layer by layer. kv_cache: stacked
    (L, ...) tensors, layer i's slices written in place; cross_kv: per-layer
    (k, v) of (B, Se, Hkv, hd), stacked (L, ...) or lists. Returns (x, aux
    summed over layers)."""
    aux = 0.0
    layers = _unstack(stacked)
    for i, (p, window) in enumerate(zip(layers, _layer_windows(cfg, len(layers)))):
        kv = None if kv_cache is None else tuple(t[i] for t in kv_cache)
        ckv = None if cross_kv is None else (cross_kv[0][i], cross_kv[1][i])
        block = functools.partial(_block_at, cfg=cfg, positions=positions, window=window,
                                  kv_cache=kv, pos=pos, causal=causal, cross_kv=ckv)
        x, a = _remat(cfg, block, x, p)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------------------
# family forwards (shared by prefill / decode)
# --------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return _embed_scaled(cfg, params["embed"][tokens].to(ACT_DTYPE))


def _embed_scaled(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Embedding rows times sqrt(d_model) where the arch scales them."""
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=ACT_DTYPE, device=x.device)
    return x


def _logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ w.float()
    return softcap(logits, cfg.logit_softcap)


def _positions_for(cfg: ArchConfig, B: int, S: int, offset: int = 0, device=None):
    pos = (offset + torch.arange(S, device=device))[None, :].expand(B, S)
    if cfg.mrope_sections:
        return pos[:, :, None].expand(B, S, 3)
    return pos


def _vlm_positions(cfg: ArchConfig, B: int, n_vis: int, S_text: int, device=None):
    """M-RoPE: grid (t=0, h=row, w=col) for the vision prefix, collapsed
    text positions after."""
    side = max(1, int(n_vis ** 0.5))
    vi = torch.arange(n_vis, device=device)
    vis = torch.stack([torch.zeros_like(vi), vi // side, vi % side], dim=-1)
    ti = 1 + torch.arange(S_text, device=device)
    txt = torch.stack([ti, ti, ti], dim=-1)
    return torch.cat([vis, txt], dim=0)[None].expand(B, n_vis + S_text, 3)


def _mamba_layer(x, p, cfg: ArchConfig, ssm_cache, li: int):
    """Mamba-2 layer ``li`` of the flat (groups, then tail) order; its state
    is read from and written back into the stacked cache."""
    c = None if ssm_cache is None else _layer(ssm_cache, li)
    h, new = SSM.mamba2_forward(p["m"], rms_norm(x, p["ln"], cfg.norm_eps),
                                cfg.ssm_state, cfg.ssm_expand, cfg.ssm_headdim, cache=c)
    if c is not None:
        _store(c, new)
    return x + h


def _zamba_groups(cfg: ArchConfig, params, unstack) -> list:
    """Zamba-2's Mamba-2 layers by group (``unstack`` of the stacked groups,
    then of the tail's leftover layers); the shared attention block follows
    each of the first ``n_layers // attn_every`` groups."""
    mamba = [unstack(group) for group in unstack(params["mamba_groups"])]
    if cfg.n_layers % cfg.attn_every:
        mamba.append(unstack(params["mamba_tail"]))
    return mamba


def _zamba_forward(cfg: ArchConfig, params, x, positions, *, cache=None, pos=0):
    n = cfg.attn_every
    G = cfg.n_layers // n
    ssm_cache = None if cache is None else cache["ssm"]      # stacked (L, ...)
    aux = 0.0
    for g, layers in enumerate(_zamba_groups(cfg, params, _unstack)):
        for j, p in enumerate(layers):
            x = _remat(cfg, functools.partial(_mamba_layer, cfg=cfg, ssm_cache=ssm_cache,
                                              li=g * n + j), x, p)
        if g < G:
            kv = None if cache is None else (cache["k"][g], cache["v"][g])
            x, a = _attn_mlp_block(cfg, params["shared_attn"], x, positions,
                                   window=NO_WINDOW, kv_cache=kv, pos=pos)
            aux = aux + a
    return x, cache, aux


def _xlstm_super(x, p, cfg: ArchConfig, cache_m, cache_s):
    """One xLSTM super-block (its mLSTM layers, then the sLSTM); the states
    are read from and written back into the super-block's cache slices."""
    for j, pp in enumerate(_unstack(p["mlstm"])):
        c = None if cache_m is None else _layer(cache_m, j)
        h, new = XL.mlstm_forward(pp["x"], rms_norm(x, pp["ln"], cfg.norm_eps),
                                  cfg.n_heads, cache=c)
        if c is not None:
            _store(c, new)
        x = x + h
    h, new = XL.slstm_forward(p["slstm"]["x"], rms_norm(x, p["slstm"]["ln"], cfg.norm_eps),
                              cache=cache_s)
    if cache_s is not None:
        _store(cache_s, new)
    return x + h


def _xlstm_forward(cfg: ArchConfig, params, x, *, cache=None):
    for s, p in enumerate(_unstack(params["super"])):
        cm = None if cache is None else _layer(cache["mlstm"], s)
        cs = None if cache is None else _layer(cache["slstm"], s)
        x = _remat(cfg, functools.partial(_xlstm_super, cfg=cfg, cache_m=cm, cache_s=cs),
                   x, p)
    return x, cache, 0.0


def forward_core(cfg: ArchConfig, params, x, positions, *, cache=None, pos=0):
    """Runs the body stack. Returns (hidden, cache, aux_loss); the cache is
    the one given, updated in place (None without one)."""
    fam = _family(cfg)
    if fam in ("dense", "moe", "vlm"):
        if cache is None:
            kv = None
        elif "k_scale" in cache:
            kv = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
        else:
            kv = (cache["k"], cache["v"])
        x, aux = _run_layers(cfg, params["layers"], x, positions, kv_cache=kv, pos=pos)
        return x, cache, aux
    if fam == "hybrid":
        return _zamba_forward(cfg, params, x, positions, cache=cache, pos=pos)
    if fam == "ssm":
        return _xlstm_forward(cfg, params, x, cache=cache)
    raise RuntimeError("encdec is handled in prefill / decode_step")


def _whisper_encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    x = frames.to(ACT_DTYPE)
    pos = _positions_for(cfg, frames.shape[0], frames.shape[1], device=x.device)
    x, _ = _run_layers(cfg, params["enc_layers"], x, pos, causal=False)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, params, enc: torch.Tensor) -> tuple[list, list]:
    """Each decoder layer's cross k and v, (B, Se, Hkv, hd), from the encoder
    output: two lists of new tensors (the loss takes their gradients)."""
    layers = _unstack(params["dec_layers"]["cross"])
    return ([_proj(enc, p, "wk", None, cfg.n_kv_heads, cfg.hd) for p in layers],
            [_proj(enc, p, "wv", None, cfg.n_kv_heads, cfg.hd) for p in layers])


def _whisper_cross_kv(cfg: ArchConfig, params, enc: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor) -> None:
    """Each decoder layer's cross k / v from the encoder output, written into
    the stacked (L, B, Se, Hkv, hd) ``ck`` / ``cv``."""
    for i, (k, v) in enumerate(zip(*_cross_kv(cfg, params, enc))):
        ck[i] = k
        cv[i] = v


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                kv_dtype=None) -> dict:
    """The decode cache of (cfg, batch, max_len) as shapes and dtypes only:
    tensors on the ``meta`` device (the reference's ShapeDtypeStructs)."""
    return make_cache(cfg, batch, max_len, dtype, abstract=True, kv_dtype=kv_dtype)


def make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               abstract: bool = False, kv_dtype=None, device=None) -> dict:
    """Zeroed decode cache of ``cfg`` on ``device`` (None: the card;
    ``abstract``: the ``meta`` device, shapes only), the reference's tree:
    stacked KV (L, B, max_len, Hkv, hd) for dense / moe / vlm
    (``kv_dtype="int8"`` adds per-(token, head) f32 scales); zamba2's
    per-layer ``SSMCache`` and per-group KV (G, B, max_len, Hkv, hd);
    xlstm's ``MLSTMCache`` / ``SLSTMCache``; whisper's self KV and its
    cross ``ck`` / ``cv`` of ``cross_len`` encoder positions. ``dtype``
    (of the k / v entries) defaults to the activations' (``ACT_DTYPE``)."""
    fam = _family(cfg)
    dtype = ACT_DTYPE if dtype is None else dtype
    device = torch.device("meta") if abstract else resolve_device(device)
    hd, Hkv, B, L = cfg.hd, cfg.n_kv_heads, batch, cfg.n_layers
    f32 = torch.float32

    def arr(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if fam in ("dense", "moe", "vlm"):
        shape = (L, B, max_len, Hkv, hd)
        if kv_dtype == "int8":
            return {"k": arr(shape, torch.int8), "v": arr(shape, torch.int8),
                    "k_scale": arr(shape[:-1], f32), "v_scale": arr(shape[:-1], f32)}
        return {"k": arr(shape), "v": arr(shape)}
    if fam == "hybrid":
        G = L // cfg.attn_every
        d_inner = cfg.ssm_expand * cfg.d_model
        conv_dim = d_inner + 2 * cfg.ssm_state
        ssm = SSM.SSMCache(
            h=arr((L, B, d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state), f32),
            conv=arr((L, B, cfg.ssm_conv - 1, conv_dim), f32))
        return {"ssm": ssm, "k": arr((G, B, max_len, Hkv, hd)),
                "v": arr((G, B, max_len, Hkv, hd))}
    if fam == "ssm":
        n_super, n_m = L // cfg.slstm_every, cfg.slstm_every - 1
        P = int(cfg.proj_factor * cfg.d_model) // cfg.n_heads
        H, D = cfg.n_heads, cfg.d_model
        return {"mlstm": XL.MLSTMCache(C=arr((n_super, n_m, B, H, P, P), f32),
                                       n=arr((n_super, n_m, B, H, P), f32),
                                       m=arr((n_super, n_m, B, H), f32)),
                "slstm": XL.SLSTMCache(*(arr((n_super, B, D), f32) for _ in range(4)))}
    return {"k": arr((L, B, max_len, Hkv, hd)), "v": arr((L, B, max_len, Hkv, hd)),
            "ck": arr((L, B, cfg.cross_len, Hkv, hd)),
            "cv": arr((L, B, cfg.cross_len, Hkv, hd))}


GROWN = ("k", "v", "k_scale", "v_scale")  # the cache entries with a time axis


def grow_cache(cache: dict, max_len: int) -> dict:
    """A new cache of ``max_len`` slots whose first slots hold ``cache``'s
    (its entries keep their dtypes: bf16, or int8 with their scales): how a
    prefill's cache, sized to the prompt, becomes one that decode can extend.
    Only the self-attention entries grow (their axis 2); recurrent states
    and whisper's cross ``ck`` / ``cv`` are copied at their size. The
    reference's tests grow theirs the same way (tests/test_arch_smoke.py).
    A placed cache (a tree of ``Blocks``) is gathered, grown and placed
    again by ``cache_shardings``, in the long-context layout (``shard_seq``)
    when its k's sequence was spread over the data axes too: a reshard
    between steps, outside any step's collectives."""
    placed = [b for _, b in _leaves(cache) if isinstance(b, Blocks)]
    if placed:
        mesh = placed[0].sharding.mesh
        seq = KV.seq_axes(cache["k"]) if "k" in cache else ()
        grown = grow_cache(gather_tree(cache), max_len)
        return shard_tree(grown, cache_shardings(grown, mesh,
                                                 shard_seq=any(a != "model" for a in seq)))
    out = {}
    for key, t in cache.items():
        if key not in GROWN:
            out[key] = (type(t)(*(s.clone() for s in t)) if isinstance(t, tuple)
                        else t.clone())
            continue
        if max_len < t.shape[2]:
            raise ValueError(f"cannot grow a cache of {t.shape[2]} slots to {max_len}")
        out[key] = torch.zeros(t.shape[:2] + (max_len,) + t.shape[3:], dtype=t.dtype,
                               device=t.device)
        out[key][:, :, :t.shape[2]] = t
    return out


# --------------------------------------------------------------------------
# public API: train_loss / prefill / decode_step
# --------------------------------------------------------------------------


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"].device
    return torch.as_tensor(tokens, device=dev).long()


def _input(params, batch: dict, key: str) -> torch.Tensor:
    """A modality input (frames, vision embeddings) on the params' device, in
    the activation dtype, as the reference casts it."""
    return torch.as_tensor(batch[key], device=params["embed"].device).to(ACT_DTYPE)


LOSS_CHUNK = 512  # sequence positions of logits at a time, as the reference's


def _xent_sums(logz_gold, hidden, targets, mask):
    """(sum of the masked cross entropy + 1e-4 z-loss, sum of the mask) over
    the sequence chunks, at most one (B, chunk, V) block of logits at a
    time. ``logz_gold(h, t)`` gives the logsumexp and the gold logit of
    hidden states ``h`` against targets ``t``: one device's logits
    (``_logz_gold``) or the vocab-parallel ones (``tensor_parallel.Vocab``)."""
    S = hidden.shape[1]
    n = max(1, S // LOSS_CHUNK)
    if S % n:  # the reference's rule: chunks of equal size, else one
        n = 1
    c = S // n
    tot, cnt = 0.0, 0.0
    for sl in (slice(i * c, (i + 1) * c) for i in range(n)):
        logz, gold = logz_gold(hidden[:, sl], targets[:, sl])
        m = mask[:, sl]
        tot = tot + torch.sum((logz - gold) * m + 1e-4 * logz * logz * m)
        cnt = cnt + torch.sum(m)
    return tot, cnt


def _logz_gold(cfg: ArchConfig, params):
    def fn(h, t):
        logits = _logits(cfg, params, h)
        return torch.logsumexp(logits, dim=-1), logits.gather(-1, t[..., None])[..., 0]
    return fn


def _xent_loss(cfg: ArchConfig, params, hidden, targets, mask):
    """The reference's cross entropy with its z-loss: the mean over the
    masked-in positions."""
    tot, cnt = _xent_sums(_logz_gold(cfg, params), hidden, targets, mask)
    return tot / torch.clamp(cnt, min=1.0)


def _next_token(tokens: torch.Tensor, n_prefix: int = 0):
    """(targets, mask) of next-token prediction over ``tokens`` (B, S) behind
    ``n_prefix`` positions without a loss (qwen2-vl's vision prefix): the
    targets shifted left, the prefix and the last position masked out."""
    B, S = tokens.shape
    dev = tokens.device
    tgt, mask = tokens, torch.ones((B, S), dtype=torch.float32, device=dev)
    if n_prefix:
        tgt = torch.cat([torch.zeros((B, n_prefix), dtype=tokens.dtype, device=dev), tgt], 1)
        mask = torch.cat([torch.zeros((B, n_prefix), device=dev), mask], 1)
    tgt = torch.cat([tgt[:, 1:], tgt[:, :1]], dim=1)
    mask = torch.cat([mask[:, 1:] * mask[:, :-1], torch.zeros_like(mask[:, :1])], dim=1)
    return tgt, mask


def _lm_input(cfg: ArchConfig, x, vis, B: int, S: int, device):
    """(input, positions, prefix length) of the decoder stack: the token
    embeddings ``x`` behind qwen2-vl's vision prefix ``vis`` (M-RoPE
    positions), or ``x`` alone (``vis`` None)."""
    if vis is None:
        return x, _positions_for(cfg, B, S, device=device), 0
    n_vis = vis.shape[1]
    return (torch.cat([vis, x], dim=1), _vlm_positions(cfg, B, n_vis, S, device=device),
            n_vis)


def train_loss(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch`` (``tokens`` (B, S); whisper's ``frames``,
    qwen2-vl's ``vision_embeds``, as in ``prefill``): a float32 scalar on
    the params' device, ``+ 0.01 * aux`` for the MoE. No cache is made.
    Under ``use_mesh`` the params are ``Blocks`` (``param_shardings``; full
    tensors are placed by the tp rules) and the loss is computed on the
    mesh (``_train_loss_tp``)."""
    fam = _family(cfg)
    mesh = current_mesh()
    if mesh is not None:
        return _train_loss_tp(cfg, params, batch, mesh)
    if fam == "encdec":
        return _whisper_loss(cfg, params, batch)
    tokens = _tokens(params, batch["tokens"])
    B, S = tokens.shape
    vis = _input(params, batch, "vision_embeds") if fam == "vlm" else None
    x, positions, n_prefix = _lm_input(cfg, _embed(cfg, params, tokens), vis, B, S,
                                       tokens.device)
    h, _, aux = forward_core(cfg, params, x, positions)
    h = rms_norm(h, params["ln_final"], cfg.norm_eps)
    return _xent_loss(cfg, params, h, *_next_token(tokens, n_prefix)) + 0.01 * aux


def _whisper_loss(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Whisper's decoder loss over all of the encoder's frames; the cross
    k / v are built per layer (``_cross_kv``), so ``dec_layers.cross.wk`` /
    ``wv`` get their gradients."""
    enc = _whisper_encode(cfg, params, _input(params, batch, "frames"))
    ck, cv = _cross_kv(cfg, params, enc)
    tokens = _tokens(params, batch["tokens"])
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    x, _ = _run_layers(cfg, params["dec_layers"], x,
                       _positions_for(cfg, B, S, device=tokens.device), cross_kv=(ck, cv))
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _xent_loss(cfg, params, x, *_next_token(tokens))


def prefill(cfg: ArchConfig, params, batch: dict):
    """Full-sequence forward that fills a new cache of the prompt's length;
    returns (last_logits (B, 1, V) f32, cache). ``batch["tokens"]`` is a
    (B, S) array or tensor; whisper also takes ``batch["frames"]`` (B, Se, D)
    and qwen2-vl ``batch["vision_embeds"]`` (B, n_vision, D), arrays or
    tensors of any float dtype. Under ``use_mesh`` the params are ``Blocks``
    (or full tensors, placed by the tp rules) and the cache comes back as a
    tree of ``Blocks`` placed by ``cache_shardings`` (``_prefill_tp``)."""
    fam = _family(cfg)
    mesh = current_mesh()
    if mesh is not None:
        return _prefill_tp(cfg, params, batch, mesh)
    tokens = _tokens(params, batch["tokens"])
    B, S = tokens.shape
    dev = tokens.device
    if fam == "encdec":
        enc = _whisper_encode(cfg, params, _input(params, batch, "frames"))
        enc = enc[:, :cfg.cross_len]
        cache = make_cache(cfg, B, S, device=dev)
        # fewer frames than cross_len: the cross k / v hold those positions
        cache["ck"], cache["cv"] = (cache[k][:, :, :enc.shape[1]] for k in ("ck", "cv"))
        _whisper_cross_kv(cfg, params, enc, cache["ck"], cache["cv"])
        x = _embed(cfg, params, tokens)
        h, _ = _run_layers(cfg, params["dec_layers"], x, _positions_for(cfg, B, S, device=dev),
                           kv_cache=(cache["k"], cache["v"]), pos=0,
                           cross_kv=(cache["ck"], cache["cv"]))
    else:
        x = _embed(cfg, params, tokens)
        if fam == "vlm":
            vis = _input(params, batch, "vision_embeds")
            x = torch.cat([vis, x], dim=1)
            positions = _vlm_positions(cfg, B, vis.shape[1], S, device=dev)
        else:
            positions = _positions_for(cfg, B, S, device=dev)
        cache = make_cache(cfg, B, x.shape[1], device=dev)
        h, cache, _ = forward_core(cfg, params, x, positions, cache=cache, pos=0)
    h = rms_norm(h[:, -1:], params["ln_final"], cfg.norm_eps)
    return _logits(cfg, params, h), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One decode step: tokens (B, 1), ``cache`` holds ``pos`` valid entries
    and takes the new one at ``pos`` (in place). Returns (logits (B, 1, V)
    f32, cache). For qwen2-vl, slot ``pos`` holds text token
    ``pos - n_vision_tokens``. Under ``use_mesh`` the params and the cache
    are placed trees (``_decode_step_tp``)."""
    fam = _family(cfg)
    mesh = current_mesh()
    if mesh is not None:
        return _decode_step_tp(cfg, params, cache, tokens, pos, mesh)
    tokens = _tokens(params, tokens)
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens)
    if cfg.mrope_sections:
        # the M-RoPE stream continues the collapsed text positions (1-based)
        positions = torch.full((B, 1, 3), pos - cfg.n_vision_tokens + 1,
                               dtype=torch.int64, device=x.device)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if fam == "encdec":
        x, _ = _run_layers(cfg, params["dec_layers"], x, positions,
                           kv_cache=(cache["k"], cache["v"]), pos=pos,
                           cross_kv=(cache["ck"], cache["cv"]))
    else:
        x, cache, _ = forward_core(cfg, params, x, positions, cache=cache, pos=pos)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _logits(cfg, params, x), cache


# --------------------------------------------------------------------------
# sharded training: train_loss under use_mesh (distributed.tensor_parallel)
# --------------------------------------------------------------------------


def _unstack_placed(stacked) -> list:
    """``_unstack`` of a tree of ``Blocks`` (the layers' per-rank views)."""
    if isinstance(stacked, dict):
        per = {k: _unstack_placed(v) for k, v in stacked.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return stacked.unbind()


def _remat_act(cfg: ArchConfig, fn, x: Act):
    """``_remat`` of a block over a per-rank activation; the recomputation
    (in the backward, outside ``use_mesh``) runs in the forward's mesh and
    sharding context."""
    if cfg.remat and torch.is_grad_enabled() and any(
            t.requires_grad for xd in x.parts for t in (xd if isinstance(xd, tuple) else (xd,))):
        ctx = TP.current()

        def in_ctx(x):
            with use_mesh(ctx.mesh), TP.active(ctx):
                return fn(x)
        return torch.utils.checkpoint.checkpoint(in_ctx, x, use_reentrant=False)
    return fn(x)


def _kv_proj(cfg: ArchConfig, pm, x, m: int, n: int, gathered, bias: bool = True):
    """(k, v) of compute rank ``m`` (B, S, count, hd) from its ``x``: the kv
    heads its q heads read (``kv_heads_for``: a straddled group's two or
    more; zero-width for a rank without q heads), from its own column
    blocks ``pm`` of ``wk`` / ``wv`` when the kv heads split evenly over the
    ``n`` ranks, else cut from the weights ``gathered`` over ``model``."""
    hd = cfg.hd
    first, cnt = TP.kv_heads_for(m, n, cfg.n_heads, cfg.n_kv_heads)
    if cnt == 0:
        empty = x.new_zeros((*x.shape[:2], 0, hd))
        return empty, empty
    if gathered is not None:
        cols = slice(first * hd, (first + cnt) * hd)
        pm = {k: t[..., cols] for k, t in gathered.items()}
    return (_proj(x, pm, "wk", "bk" if bias else None, cnt, hd),
            _proj(x, pm, "wv", "bv" if bias else None, cnt, hd))


def _kv_gathered(cfg: ArchConfig, ctx, p, d: int, keys=("wk", "wv", "bk", "bv")):
    """The kv weights gathered over ``model`` (recorded) when the kv heads do
    not split evenly over the compute ranks (qwen2-7b's one kv head of
    ``reduced()`` on two or four ranks, its 4 of 28 on 16: every uneven
    q split is one of these); None when each rank's own column blocks hold
    the whole kv heads its q heads read."""
    n = ctx.n_tp
    if n == 1 or cfg.n_kv_heads % n == 0:
        return None
    cols = cfg.n_kv_heads * cfg.hd
    return {k: ctx.gather_model(p[k], d, p[k][0].ndim - 1, cols) for k in keys if k in p}


def _q_tp(cfg: ArchConfig, ctx, p, x, d: int) -> list:
    """Each compute rank's q (B, S, heads, hd) of data rank d's whole ``x``:
    its ``head_range`` of the q heads (ceil(Hq / n) a rank, none past the
    last: GSPMD's padded layout), from the ``wq`` columns they read (and
    ``bq``'s). Columns outside the rank's own block move as weights or as
    products, whichever is fewer bytes (``col_product``; the bias as
    pieces, ``take``); no rank gathers ``wq`` whole. None for a rank without
    heads."""
    n, hd, Hq = ctx.n_tp, cfg.hd, cfg.n_heads
    heads = [TP.head_range(Hq, n, m) for m in range(n)]
    want = [[(a * hd, b * hd)] if b > a else [] for a, b in heads]
    qs = TP.col_product(ctx, x, p["wq"], Hq * hd, d, want)
    if "bq" in p:
        bs = TP.take(ctx, [b.to(x.dtype) for b in p["bq"]], d, -1,
                     TP.block_ranges(Hq * hd, n), want)
        qs = [None if q is None else q + b.to(q.device) for q, b in zip(qs, bs)]
    return [None if q is None else q.reshape(*x.shape[:2], b - a, hd)
            for q, (a, b) in zip(qs, heads)]


def _heads_attend(cfg: ArchConfig, ctx, qs: list, ks: list, vs: list, **kw) -> list:
    """Each compute rank's attention of its q heads over its kv heads
    (B, S, heads x hd), one flash call per ``attn_calls`` entry (each a
    uniform GQA group: the runs of a straddled kv group apart, k / v sliced,
    never repeated per q head); None, and no call, for a rank without
    heads."""
    def attend(q, k, v):
        return A.attention(q, k, v, softcap=cfg.attn_softcap, **kw)
    ys = []
    for m, (q, k, v) in enumerate(zip(qs, ks, vs)):
        o = None if q is None else TP.per_call(attend, m, ctx.n_tp, cfg.n_heads,
                                               cfg.n_kv_heads, q, (k, v))
        ys.append(None if o is None else o.reshape(*o.shape[:2], -1))
    return ys


def _wo_tp(cfg: ArchConfig, ctx, wo: list, ys: list, d: int, split: bool):
    """``wo`` row-parallel over each compute rank's heads' output ``ys[m]``
    (``row_product``: its heads' rows moved to it as weights, or its output
    columns to the rows' owners as products, whichever is fewer bytes; a
    rank without heads adds nothing), ending in ``row_end``."""
    n, hd, Hq = ctx.n_tp, cfg.hd, cfg.n_heads
    have = [[(a * hd, b * hd)] if b > a else [] for a, b in
            (TP.head_range(Hq, n, m) for m in range(n))]
    return TP.row_product(ctx, ys, have, wo, Hq * hd, d, split)


def _rope_rank(cfg: ArchConfig, t, pos):
    """``_rope`` of one rank's q or k, of no heads as it is."""
    return t if t is None or t.shape[2] == 0 else _rope(cfg, t, pos)


def _qkv_tp(cfg: ArchConfig, ctx, p, x, positions, d: int):
    """Each compute rank's q (``_q_tp``) and k / v (``_kv_proj``) of data
    rank d's whole ``x``, roped at ``positions``."""
    n = ctx.n_tp
    qs = _q_tp(cfg, ctx, p, x, d)
    gathered = _kv_gathered(cfg, ctx, p, d)
    ks, vs = [], []
    for m in range(n):
        pm = {k: v[m] for k, v in p.items()}
        k, v = _kv_proj(cfg, pm, x.to(pm["wk"].device), m, n, gathered)
        pos = ctx.to_rank(positions, d, m)
        qs[m], k = _rope_rank(cfg, qs[m], pos), _rope_rank(cfg, k, pos)
        ks.append(k)
        vs.append(v)
    return qs, ks, vs


def _attn_tp(cfg: ArchConfig, ctx, p, xd, positions, d: int, *, window, causal=True,
             kv_override=None, kv=None):
    """``_attn`` of data rank ``d`` with its compute ranks' blocks ``p``:
    each rank's ``head_range`` of q heads and the kv heads they read
    (``_qkv_tp``), its attention over them (``_heads_attend``: the flash
    kernel on the card), and ``wo`` row-parallel (``_wo_tp``).
    ``kv_override``: each rank's cross (k, v). ``kv``: a prefill's cache
    layer (``kv_cache.LayerKV``), which takes the sequence's k / v;
    attention then reads them in the cache's dtype, as one device reads its
    cache."""
    x = ctx.seq_full(xd, d)
    if kv_override is not None:
        qs, (ks, vs) = _q_tp(cfg, ctx, p, x, d), kv_override
        kw = dict(causal=False, kv_len=ks[0].shape[1])
    else:
        qs, ks, vs = _qkv_tp(cfg, ctx, p, x, positions, d)
        kw = dict(causal=causal, kv_len=x.shape[1])
    if kv is not None:
        KV.write(ctx, kv, d, ks, vs, 0, (cfg.n_heads, cfg.n_kv_heads), _quantize_kv)
        ks, vs = ([t.to(kv.k.dtype) for t in ts] for ts in (ks, vs))
    ys = _heads_attend(cfg, ctx, qs, [k.to(x.dtype) for k in ks], [v.to(x.dtype) for v in vs],
                       window=window, q_offset=0, **kw)
    return _wo_tp(cfg, ctx, p["wo"], ys, d, isinstance(xd, tuple))


def _attn_cached_tp(cfg: ArchConfig, ctx, p, xd, positions, d: int, *, window, kv,
                    pos=None):
    """A decode step's attention of data rank ``d`` over its placed cache
    layer ``kv``: the new token's q / k / v per rank as in ``_attn_tp``,
    its k / v written at ``pos`` (``kv_cache.write``), the attention over
    the cache's positions [0, pos] (``kv_cache.attend``: per sequence slice
    through the flash kernel's lse, then combined), and ``wo``
    row-parallel. ``pos`` None: cross attention over every position of
    ``kv`` (no write, no rope)."""
    x = ctx.seq_full(xd, d)
    heads = (cfg.n_heads, cfg.n_kv_heads)
    if pos is None:
        qs = _q_tp(cfg, ctx, p, x, d)
        kw = dict(kv_len=kv.k.shape[1], causal=False, window=NO_WINDOW)
    else:
        qs, ks, vs = _qkv_tp(cfg, ctx, p, x, positions, d)
        KV.write(ctx, kv, d, ks, vs, pos, heads, _quantize_kv)
        kw = dict(kv_len=pos + 1, causal=True, window=window)
    outs = KV.attend(ctx, kv, d, qs, softcap=cfg.attn_softcap, heads=heads, **kw)
    ys = [None if o is None else o.reshape(*o.shape[:2], -1) for o in outs]
    return _wo_tp(cfg, ctx, p["wo"], ys, d, isinstance(xd, tuple))


def _block_tp(x: Act, p, cfg: ArchConfig, positions, *, window, causal=True,
              cross_kv=None, kv=None, pos=None):
    """``_attn_mlp_block`` over the mesh: attention per data rank, the MLP
    per data rank or the MoE over all of them (global routing). Serving:
    ``kv`` is the layer's placed cache (``kv_cache.LayerKV``), written by a
    prefill (``pos`` None) or written and read by a decode step at ``pos``;
    a decode step's ``cross_kv`` is the cross cache's ``LayerKV``."""
    ctx = TP.current()
    eps = cfg.norm_eps

    def norm(t, w):
        return rms_norm(t, w, eps)

    views = ctx.each(lambda d: ctx.view(p, d))

    def attn(d):
        xd, pv = x.parts[d], views[d]
        normed = ctx.rowwise(norm, xd, pv["ln_attn"])
        if kv is not None and pos is not None:
            h = _attn_cached_tp(cfg, ctx, pv["attn"], normed, positions[d], d, window=window,
                                kv=kv, pos=pos)
        else:
            h = _attn_tp(cfg, ctx, pv["attn"], normed, positions[d], d, window=window,
                         causal=causal, kv=kv)
        if cfg.sandwich_norm:
            h = ctx.rowwise(norm, h, pv["ln_attn_post"])
        xd = ctx.add(xd, h)
        if "cross" in pv:
            normed = ctx.rowwise(norm, xd, pv["ln_cross"])
            if isinstance(cross_kv, KV.LayerKV):
                h = _attn_cached_tp(cfg, ctx, pv["cross"], normed, positions[d], d,
                                    window=window, kv=cross_kv)
            else:
                h = _attn_tp(cfg, ctx, pv["cross"], normed, positions[d], d, window=window,
                             kv_override=cross_kv[d])
            xd = ctx.add(xd, h)
        return xd
    parts = ctx.each(attn)
    h_in = ctx.each(lambda d: ctx.rowwise(norm, parts[d], views[d]["ln_mlp"]))
    aux = 0.0
    if cfg.n_experts:
        moe = MOE.moe_dense_tp if cfg.moe_impl == "dense" else MOE.moe_tp
        hs, aux = moe(ctx, [pv["moe"] for pv in views], h_in, cfg.moe_top_k)
    else:
        hs = ctx.each(lambda d: F.mlp_tp(ctx, views[d]["mlp"], h_in[d], cfg.mlp_act, d))
    if cfg.sandwich_norm:
        hs = ctx.each(lambda d: ctx.rowwise(norm, hs[d], views[d]["ln_mlp_post"]))
    return shard_act(Act(ctx.each(lambda d: ctx.add(parts[d], hs[d]))), "btd"), aux


def _run_layers_tp(cfg: ArchConfig, stacked, x: Act, positions, *, causal=True,
                   cross_kv=None, kv=None, pos=None):
    """``_run_layers`` over the mesh; ``cross_kv[i]``: layer i's cross (k, v)
    per data rank per compute rank, or (decode) its cross cache's
    ``LayerKV``; ``kv[i]``: layer i's self-attention cache (serving)."""
    aux = 0.0
    layers = _unstack_placed(stacked)
    for i, (p, window) in enumerate(zip(layers, _layer_windows(cfg, len(layers)))):
        block = functools.partial(_block_tp, p=p, cfg=cfg, positions=positions, window=window,
                                  causal=causal,
                                  cross_kv=None if cross_kv is None else cross_kv[i],
                                  kv=None if kv is None else kv[i], pos=pos)
        x, a = _remat_act(cfg, block, x)
        aux = aux + a
    return x, aux


def _gathered_block(x: Act, p, fn, states=None):
    """A block whose weights each data rank gathers whole first (recorded),
    then runs as one device: every block in fsdp mode, the reference's
    FSDP semantics (a layer's weights all-gathered before its use).
    ``states[d]``: data rank d's recurrent state, ``fn``'s third argument
    (serving)."""
    ctx = TP.current()

    def run(d):
        xd = x.parts[d]
        xf, w = ctx.seq_full(xd, d), ctx.full_view(p, d)
        return ctx.like(fn(xf, w) if states is None else fn(xf, w, states[d]), xd, d)
    return Act(ctx.each(run))


def _states_tp(ctx, state, axis: int):
    """Per data rank, (each model rank's replica of its rows of a placed
    stacked recurrent state, the model ranks whose replicas are distinct
    tensors), and a function that writes back what is not a view. The
    state is placed batch only (``cache_shardings``), so each model rank's
    own block holds its data rank's rows whole: views of it. Where another
    axis is split instead (a batch the data axes do not divide, as
    ``shard_seq`` serving's batch of 1), the data rank's rows are read once
    (``_states``) and its model ranks share that tensor. (None, a no-op)
    without a state."""
    if state is None:
        return None, lambda: None

    def view(d, m):
        coord = np.unravel_index(d * ctx.n_model + m, state[0].grid.shape)
        r0, r1 = ctx.rows(state[0].shape[axis], d)
        leaves = []
        for b in state:
            box = b.box(coord)
            if any(k != axis and (lo, hi) != (0, b.shape[k]) for k, (lo, hi) in enumerate(box)) \
                    or not box[axis][0] <= r0 <= r1 <= box[axis][1]:
                return None
            leaves.append(b.grid[coord].narrow(axis, r0 - box[axis][0], r1 - r0))
        return type(state)(*leaves)
    views = ctx.each(lambda d: [view(d, m) for m in range(ctx.n_model)])
    if any(v is None for per_d in views for v in per_d):
        read, back = _states(ctx, state, axis)
        return [([r] * ctx.n_model, [0]) for r in read], back
    out = []
    for d, reps in enumerate(views):
        coords = [np.unravel_index(d * ctx.n_model + m, state[0].grid.shape)
                  for m in range(ctx.n_model)]
        blocks = [id(state[0].grid[c]) for c in coords]
        out.append((reps, [m for m in range(ctx.n_model) if blocks.index(blocks[m]) == m]))
    return out, lambda: None


def _write_state(ctx, d: int, reps: list, owners: list, items: list) -> None:
    """Writes each model rank's new state pieces ``items`` ((field, index,
    value) triples) into its data rank's replicas of the layer's state
    ``reps``: into its own, and, to join the heads' (or rows') pieces, into
    every other distinct one. A debug mesh shares one tensor; distinct
    cards all-gather it (recorded: the layer's whole state, one op)."""
    with C.trace().quiet():
        for field, index, value in items:
            for m in owners:
                dst = reps[m][field][index]
                dst.copy_(value.to(dst.device))
    if d == 0 and ctx.n_tp > 1:
        ctx.mesh.record("all-gather", sum(t.numel() * t.element_size() for t in reps[0]))


def _mamba_tp(x: Act, p, cfg: ArchConfig, states=None, li: int = 0):
    """A Mamba-2 layer over the mesh in tp mode: ``ssm.mamba2_tp`` per data
    rank, its heads split over the model ranks, every rank's scan batched
    where ranks share a device (``tensor_parallel.each_grouped``); serving
    reads and writes layer ``li`` of ``states`` (``_states_tp``)."""
    ctx = TP.current()
    P, di, N = cfg.ssm_headdim, cfg.ssm_expand * cfg.d_model, cfg.ssm_state

    def run(d):
        xd, pv = x.parts[d], ctx.view(p, d)
        xf = rms_norm(ctx.seq_full(xd, d), pv["ln"][0], cfg.norm_eps)
        reps = None if states is None else [_layer(r, li) for r in states[d][0]]
        h, news = yield from SSM.mamba2_tp(ctx, pv["m"], xf, d, N, cfg.ssm_expand, P,
                                           cache=reps, split=isinstance(xd, tuple))
        if reps is not None:
            items = []
            for m, new in enumerate(news):
                if new is None:
                    continue
                a, b = TP.head_range(di // P, ctx.n_tp, m)
                c = (b - a) * P
                items += [(0, (slice(None), slice(a, b)), new.h),
                          (1, (..., slice(a * P, b * P)), new.conv[..., :c])]
                if m == 0:  # B / C's channels: every rank computes them alike
                    items.append((1, (..., slice(di, di + 2 * N)), new.conv[..., c:]))
            _write_state(ctx, d, reps, states[d][1], items)
        return ctx.add(xd, h)
    return Act(TP.each_grouped(ctx, run))


def _xlstm_super_tp(x: Act, p, cfg: ArchConfig, states=None, i: int = 0):
    """An xLSTM super-block over the mesh in tp mode: each mLSTM layer split
    by head (``xlstm.mlstm_tp``), then the sLSTM split by batch rows
    (``xlstm.slstm_tp``); serving reads and writes super-block ``i`` of
    ``states`` (the mLSTM's and the sLSTM's ``_states_tp``)."""
    ctx = TP.current()
    H = cfg.n_heads

    def run(d):
        xd = x.parts[d]
        for j, pp in enumerate(_unstack_placed(p["mlstm"])):
            pv = ctx.view(pp, d)
            xf = rms_norm(ctx.seq_full(xd, d), pv["ln"][0], cfg.norm_eps)
            reps = None if states is None else \
                [_layer(_layer(r, i), j) for r in states[0][d][0]]
            h, news = yield from XL.mlstm_tp(ctx, pv["x"], xf, d, H, cache=reps,
                                             split=isinstance(xd, tuple))
            if reps is not None:
                _write_state(ctx, d, reps, states[0][d][1], [
                    (f, (slice(None), slice(*TP.head_range(H, ctx.n_tp, m))), t)
                    for m, new in enumerate(news) if new is not None
                    for f, t in enumerate(new)])
            xd = ctx.add(xd, h)
        pv = ctx.view(p["slstm"], d)
        xf = rms_norm(ctx.seq_full(xd, d), pv["ln"][0], cfg.norm_eps)
        reps = None if states is None else [_layer(r, i) for r in states[1][d][0]]
        h, news = yield from XL.slstm_tp(ctx, pv["x"], xf, d, cache=reps,
                                         split=isinstance(xd, tuple))
        if reps is not None:
            rows = TP.block_ranges(xf.shape[0], ctx.n_tp)
            _write_state(ctx, d, reps, states[1][d][1], [
                (f, (slice(*rows[m][0]),), t) for m, new in enumerate(news) if new is not None
                for f, t in enumerate(new)])
        return ctx.add(xd, h)
    return Act(TP.each_grouped(ctx, run))


def _forward_core_tp(cfg: ArchConfig, params, x: Act, positions, *, cache=None, pos=None):
    """``forward_core`` over the mesh. Serving: ``cache`` is the placed cache
    (a tree of ``Blocks``), written by a prefill (``pos`` None) or written
    and read by a decode step at ``pos``. In tp mode the Mamba-2 and xLSTM
    blocks split by head (``_mamba_tp``, ``_xlstm_super_tp``) and each
    model rank updates its heads' (or rows') slice of its replica of the
    recurrent state in place; in fsdp mode they run gathered
    (``_gathered_block``), the states read per data rank (``_states``) and
    written back at the end."""
    fam = _family(cfg)
    if fam in ("dense", "moe", "vlm"):
        return _run_layers_tp(cfg, params["layers"], x, positions,
                              kv=None if cache is None else KV.layers(cache), pos=pos)
    ctx = TP.current()
    tp = ctx.mode == "tp"

    def states_of(key, axis):
        state = None if cache is None else cache[key]
        return (_states_tp if tp else _states)(ctx, state, axis)
    aux = 0.0
    if fam == "hybrid":
        G, n = cfg.n_layers // cfg.attn_every, cfg.attn_every
        states, back = states_of("ssm", 1)
        kvs = None if cache is None else KV.layers(cache)
        for g, layers in enumerate(_zamba_groups(cfg, params, _unstack_placed)):
            for j, p in enumerate(layers):
                if tp:
                    block = functools.partial(_mamba_tp, p=p, cfg=cfg, states=states,
                                              li=g * n + j)
                else:
                    fn = (functools.partial(_mamba_layer, cfg=cfg, ssm_cache=None, li=0)
                          if states is None else
                          functools.partial(_mamba_state, cfg=cfg, li=g * n + j))
                    block = functools.partial(_gathered_block, p=p, fn=fn, states=states)
                x = _remat_act(cfg, block, x)
            if g < G:
                x, a = _block_tp(x, params["shared_attn"], cfg, positions, window=NO_WINDOW,
                                 kv=None if kvs is None else kvs[g], pos=pos)
                aux = aux + a
        back()
        return x, aux
    ms, back_m = states_of("mlstm", 2)  # ssm: xlstm
    ss, back_s = states_of("slstm", 1)
    for i, p in enumerate(_unstack_placed(params["super"])):
        if tp:
            block = functools.partial(_xlstm_super_tp, p=p, cfg=cfg,
                                      states=None if ms is None else (ms, ss), i=i)
        elif ms is None:
            block = functools.partial(_gathered_block, p=p, fn=functools.partial(
                _xlstm_super, cfg=cfg, cache_m=None, cache_s=None))
        else:
            block = functools.partial(_gathered_block, p=p,
                                      fn=functools.partial(_xlstm_state, cfg=cfg),
                                      states=[(_layer(m, i), _layer(s_, i))
                                              for m, s_ in zip(ms, ss)])
        x = _remat_act(cfg, block, x)
    back_m()
    back_s()
    return x, aux


def _mamba_state(x, p, state, *, cfg, li):
    return _mamba_layer(x, p, cfg, state, li)


def _xlstm_state(x, p, state, *, cfg):
    return _xlstm_super(x, p, cfg, *state)


def _states(ctx, state, axis: int):
    """Each data rank's rows of a placed stacked recurrent state (a
    NamedTuple of ``Blocks``, batch at ``axis``) as local tensors on its
    device (``read_box``: its own block when that block holds just them),
    and a function that writes them back into every block that holds them
    (``write_box``). (None, a no-op) without a state."""
    if state is None:
        return None, lambda: None

    def read(d):
        out = []
        for b in state:
            r0, r1 = ctx.rows(b.shape[axis], d)
            origin = tuple(r0 if k == axis else 0 for k in range(b.ndim))
            size = tuple(r1 - r0 if k == axis else n for k, n in enumerate(b.shape))
            out.append((b, read_box(b, origin, size, ctx.dev(d), record=d == 0), origin))
        return out
    spots = ctx.each(read)

    def back():
        for d, leaves in enumerate(spots):
            if d == 0 or not ctx.mirror:
                for b, t, origin in leaves:
                    write_box(b, t, origin)
    return [type(state)(*(t for _, t, _ in leaves)) for leaves in spots], back


def _cross_kv_tp(cfg: ArchConfig, ctx, params, enc: list) -> list:
    """Per decoder layer, per data rank: each compute rank's cross (k, v)
    from the encoder output (column-parallel ``wk`` / ``wv``, no bias, as
    ``_cross_kv``)."""
    def one(p, d):
        e, pv = enc[d], ctx.view(p, d)
        gathered = _kv_gathered(cfg, ctx, pv, d, ("wk", "wv"))
        kv = [_kv_proj(cfg, {k: pv[k][m] for k in ("wk", "wv")}, e.to(pv["wk"][m].device),
                       m, ctx.n_tp, gathered, bias=False) for m in range(ctx.n_tp)]
        return [k for k, _ in kv], [v for _, v in kv]
    return [ctx.each(functools.partial(one, p))
            for p in _unstack_placed(params["dec_layers"]["cross"])]


def _place(params, mesh):
    """Parameters as ``Blocks`` on ``mesh``: placed ones as they are, full
    tensors by the tp rules (``param_shardings``)."""
    if isinstance(params["embed"], Blocks):
        return params
    return shard_tree(params, param_shardings(params, mesh))


def _train_loss_tp(cfg: ArchConfig, params, batch: dict, mesh) -> torch.Tensor:
    """``train_loss`` on ``mesh``: the batch split over the data ranks, the
    blocks tensor-parallel (or gathered, fsdp), the embedding and logits
    vocab-parallel (``tensor_parallel.Vocab``), and the loss the global
    masked mean (psums of the data ranks' sums and counts)."""
    fam = _family(cfg)
    params = _place(params, mesh)
    ctx = TP.ShardCtx.for_params(mesh, params)
    with TP.active(ctx):
        eps = cfg.norm_eps
        vocab = ctx.each(lambda d: TP.Vocab(ctx, params, d))
        toks = ctx.split_batch(torch.as_tensor(batch["tokens"], device=ctx.dev(0)).long())
        B, S = toks[0].shape

        def split(key):
            return ctx.split_batch(torch.as_tensor(batch[key], device=ctx.dev(0)))

        def embed(d, prefix):
            # sequence blocks under sequence parallelism, unless a prefix joins
            e = vocab[d].lookup(toks[d], ctx.sp and not prefix and S % ctx.n_tp == 0,
                                ACT_DTYPE)
            return tuple(map(functools.partial(_embed_scaled, cfg), e)) \
                if isinstance(e, tuple) else _embed_scaled(cfg, e)

        aux = 0.0
        if fam == "encdec":
            frames = [f.to(ACT_DTYPE) for f in split("frames")]
            epos = [_positions_for(cfg, B, f.shape[1], device=f.device) for f in frames]
            xe, _ = _run_layers_tp(cfg, params["enc_layers"], shard_act(Act(frames), "btd"),
                                   epos, causal=False)
            enc = [rms_norm(ctx.seq_full(xd, d), ctx.full(params["ln_enc"], d), eps)
                   for d, xd in enumerate(xe.parts)]
            ckv = _cross_kv_tp(cfg, ctx, params, enc)
            positions = [_positions_for(cfg, B, S, device=ctx.dev(d)) for d in range(ctx.n_dp)]
            x = shard_act(Act(ctx.each(lambda d: embed(d, False))), "btd")
            h, _ = _run_layers_tp(cfg, params["dec_layers"], x, positions, cross_kv=ckv)
            targets = [_next_token(t) for t in toks]
        else:
            vis = split("vision_embeds") if fam == "vlm" else [None] * ctx.n_dp
            inputs = ctx.each(lambda d: _lm_input(
                cfg, embed(d, vis[d] is not None),
                None if vis[d] is None else vis[d].to(ACT_DTYPE), B, S, ctx.dev(d)))
            h, aux = _forward_core_tp(cfg, params, shard_act(Act([x for x, _, _ in inputs]),
                                                             "btd"),
                                      [pos for _, pos, _ in inputs])
            targets = [_next_token(t, n) for t, (_, _, n) in zip(toks, inputs)]
        def xent(d):
            hf = rms_norm(ctx.seq_full(h.parts[d], d), ctx.full(params["ln_final"], d), eps)
            return _xent_sums(functools.partial(vocab[d].logz_gold, cap=cfg.logit_softcap),
                              hf, *targets[d])
        sums = ctx.each(xent)
        tots, cnts = [t for t, _ in sums], [c for _, c in sums]
        loss = ctx.psum_data(tots) / torch.clamp(ctx.psum_data(cnts), min=1.0)
        return loss + 0.01 * aux if fam != "encdec" else loss


# --------------------------------------------------------------------------
# serving on a mesh: prefill / decode_step under use_mesh
# --------------------------------------------------------------------------


def _serve_ctx(mesh, params, B: int):
    """The sharded computation of a batch of ``B``: split over the data
    ranks when they divide it (the cache's rule), else computed once, as
    data rank 0 (``ShardCtx(split_data=False)``)."""
    ctx = TP.ShardCtx.for_params(mesh, params)
    return ctx if B % ctx.n_dp == 0 else TP.ShardCtx.for_params(mesh, params, False)


def _place_cache(cache: dict, mesh) -> dict:
    """A cache as a tree of ``Blocks``: a placed one as it is, full tensors
    placed by ``cache_shardings`` (a long context's ``shard_seq`` layout is
    the caller's to place)."""
    if any(isinstance(b, Blocks) for _, b in _leaves(cache)):
        return cache
    return shard_tree(cache, cache_shardings(cache, mesh))


def _embed_tp(cfg: ArchConfig, ctx, vocab: list, toks: list, prefix: bool) -> list:
    """Each data rank's token embeddings (vocab-parallel lookups)."""
    S = toks[0].shape[1]

    def one(d):
        e = vocab[d].lookup(toks[d], ctx.sp and not prefix and S % ctx.n_tp == 0, ACT_DTYPE)
        return (tuple(map(functools.partial(_embed_scaled, cfg), e)) if isinstance(e, tuple)
                else _embed_scaled(cfg, e))
    return ctx.each(one)


def _last_logits_tp(cfg: ArchConfig, ctx, params, vocab: list, h: Act) -> torch.Tensor:
    """(B, 1, V) float32 logits of the last position of every data rank's
    hidden states (vocab-parallel, all-gathered over ``model`` then over the
    data ranks, on data rank 0's device)."""
    def one(d):
        hl = rms_norm(ctx.seq_full(h.parts[d], d)[:, -1:], ctx.full(params["ln_final"], d),
                      cfg.norm_eps)
        return vocab[d].logits(hl, cfg.logit_softcap)
    return ctx.gather_data(ctx.each(one), 0)


def _prefill_tp(cfg: ArchConfig, params, batch: dict, mesh):
    """``prefill`` on ``mesh``: the batch split over the data ranks (when
    they divide it), the blocks tensor-parallel (or gathered, fsdp) as in
    ``_train_loss_tp``, and a new cache of the prompt's length placed by
    ``cache_shardings`` (its sequence over ``model``), which each attention
    layer fills by an all-to-all from its head shards
    (``kv_cache.write``). Returns (last logits (B, 1, V) f32, the placed
    cache)."""
    fam = _family(cfg)
    params = _place(params, mesh)
    tokens = torch.as_tensor(batch["tokens"]).long()
    B, S = tokens.shape
    ctx = _serve_ctx(mesh, params, B)
    with TP.active(ctx):
        vocab = ctx.each(lambda d: TP.Vocab(ctx, params, d))
        toks = ctx.split_batch(tokens.to(ctx.dev(0)))
        b = toks[0].shape[0]

        def split(key):
            return [t.to(ACT_DTYPE) for t in
                    ctx.split_batch(torch.as_tensor(batch[key], device=ctx.dev(0)))]

        if fam == "encdec":
            frames = split("frames")
            epos = [_positions_for(cfg, b, f.shape[1], device=f.device) for f in frames]
            xe, _ = _run_layers_tp(cfg, params["enc_layers"], shard_act(Act(frames), "btd"),
                                   epos, causal=False)
            enc = ctx.each(lambda d: rms_norm(ctx.seq_full(xe.parts[d], d),
                                              ctx.full(params["ln_enc"], d),
                                              cfg.norm_eps)[:, :cfg.cross_len])
            # fewer frames than cross_len: the cross k / v hold the frames' positions
            cache = _placed_cache(cfg, B, S, mesh, enc[0].shape[1])
            ckv = _cross_kv_tp(cfg, ctx, params, enc)
            cross = KV.layers(cache, "ck", "cv")
            heads = (cfg.n_heads, cfg.n_kv_heads)
            for i, per_d in enumerate(ckv):
                def write(d, i=i, per_d=per_d):
                    ks, vs = per_d[d]
                    KV.write(ctx, cross[i], d, ks, vs, 0, heads, _quantize_kv)
                    return tuple([t.to(cache["ck"].dtype).to(ACT_DTYPE) for t in ts]
                                 for ts in (ks, vs))
                ckv[i] = ctx.each(write)
            positions = [_positions_for(cfg, b, S, device=ctx.dev(d)) for d in range(ctx.n_dp)]
            x = shard_act(Act(_embed_tp(cfg, ctx, vocab, toks, False)), "btd")
            h, _ = _run_layers_tp(cfg, params["dec_layers"], x, positions, cross_kv=ckv,
                                  kv=KV.layers(cache))
        else:
            vis = split("vision_embeds") if fam == "vlm" else [None] * ctx.n_dp
            xs = _embed_tp(cfg, ctx, vocab, toks, fam == "vlm")
            inputs = [_lm_input(cfg, x, v, b, S, ctx.dev(d))
                      for d, (x, v) in enumerate(zip(xs, vis))]
            n_vis = 0 if vis[0] is None else vis[0].shape[1]
            cache = _placed_cache(cfg, B, n_vis + S, mesh)
            h, _ = _forward_core_tp(cfg, params, shard_act(Act([x for x, _, _ in inputs]), "btd"),
                                    [p for _, p, _ in inputs], cache=cache)
        return _last_logits_tp(cfg, ctx, params, vocab, h), cache


def _placed_cache(cfg: ArchConfig, B: int, S: int, mesh, cross_len: int | None = None) -> dict:
    """A zero cache of (cfg, B, S) placed by ``cache_shardings``
    (``placed_cache``); whisper's cross k / v hold ``cross_len``
    positions."""
    def specs():
        out = cache_specs(cfg, B, S)
        if cross_len is not None:
            for key in ("ck", "cv"):
                out[key] = out[key][:, :, :cross_len]
        return out
    return placed_cache(specs, mesh)


def _decode_step_tp(cfg: ArchConfig, params, cache, tokens, pos: int, mesh):
    """``decode_step`` on ``mesh``: ``cache`` is a tree of ``Blocks`` placed
    by ``cache_shardings`` (full tensors are placed so; a long-context
    cache placed with ``shard_seq``), updated in place. Each attention
    layer writes the new k / v into the rank that owns slot ``pos`` and
    attends per sequence slice (flash-decoding, ``kv_cache.attend``)."""
    fam = _family(cfg)
    params = _place(params, mesh)
    cache = _place_cache(cache, mesh)
    tokens = torch.as_tensor(tokens).long()
    B = tokens.shape[0]
    ctx = _serve_ctx(mesh, params, B)
    with TP.active(ctx):
        vocab = ctx.each(lambda d: TP.Vocab(ctx, params, d))
        toks = ctx.split_batch(tokens.to(ctx.dev(0)))
        b = toks[0].shape[0]
        x = shard_act(Act(_embed_tp(cfg, ctx, vocab, toks, False)), "btd")
        if cfg.mrope_sections:  # the collapsed text positions continue (1-based)
            positions = [torch.full((b, 1, 3), pos - cfg.n_vision_tokens + 1, dtype=torch.int64,
                                    device=ctx.dev(d)) for d in range(ctx.n_dp)]
        else:
            positions = [torch.full((b, 1), pos, dtype=torch.int64, device=ctx.dev(d))
                         for d in range(ctx.n_dp)]
        if fam == "encdec":
            h, _ = _run_layers_tp(cfg, params["dec_layers"], x, positions,
                                  cross_kv=KV.layers(cache, "ck", "cv"), kv=KV.layers(cache),
                                  pos=pos)
        else:
            h, _ = _forward_core_tp(cfg, params, x, positions, cache=cache, pos=pos)
        return _last_logits_tp(cfg, ctx, params, vocab, h), cache
