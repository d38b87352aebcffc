"""Model builder: init / prefill / decode_step of the dense family
(``qwen2-7b``, ``yi-9b``, ``codeqwen1.5-7b``, ``gemma2-27b``), as in
``repro.models.model``.

Layer parameters are stacked along a leading (L, ...) axis, leaf for leaf
as in the reference, and the layer stack is a Python loop over that axis.
KV caches are stacked the same way. Unlike the reference, whose arrays are
immutable, prefill and decode write the new k / v into the cache they are
given, in place, and return that same dict: a 27B model's cache is
gigabytes, and a copy per step would double it. The other families raise
``NotImplementedError`` until their slice is ported (ROADMAP.md, Queue 1,
item 12).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import apply_rope, dense_init, rms_norm, softcap

ACT_DTYPE = torch.bfloat16
NO_WINDOW = 1 << 30
PORTED_FAMILIES = ("dense",)


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md "
            f"Queue 1, item 12 (the moe, hybrid, ssm, encdec and vlm families)")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def _init_attn(gen, cfg: ArchConfig, dtype, L: int) -> dict:
    hd, Hq, Hkv, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": dense_init(gen, (L, D, Hq * hd), 1, dtype),
        "wk": dense_init(gen, (L, D, Hkv * hd), 1, dtype),
        "wv": dense_init(gen, (L, D, Hkv * hd), 1, dtype),
        "wo": dense_init(gen, (L, Hq * hd, D), 1, dtype),
    }
    if cfg.qkv_bias:
        zeros = dict(dtype=dtype, device=gen.device)
        p["bq"] = torch.zeros((L, Hq * hd), **zeros)
        p["bk"] = torch.zeros((L, Hkv * hd), **zeros)
        p["bv"] = torch.zeros((L, Hkv * hd), **zeros)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device=None) -> dict:
    """Random parameters of ``cfg`` from a generator seeded with ``seed`` on
    ``device`` (None: the card), drawn directly in ``dtype``: the tree and
    shapes of ``repro.models.model.init_params`` (whose draws differ: to run
    the reference's weights, carry them with ``convert.model_params_from_jax``).
    Norm scales start at 0 (rms_norm multiplies by 1 + scale)."""
    _require_dense(cfg)
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
    layers = {"attn": _init_attn(gen, cfg, dtype, L),
              "ln_attn": zeros(L, D), "ln_mlp": zeros(L, D)}
    if cfg.sandwich_norm:
        layers["ln_attn_post"] = zeros(L, D)
        layers["ln_mlp_post"] = zeros(L, D)
    if cfg.d_ff:
        layers["mlp"] = F.init_mlp(gen, D, cfg.d_ff, dtype, layers=(L,))
    params["layers"] = layers
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return int(sum(x.numel() for x in _leaves(params)))


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked (L, ...) leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


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
          kv_cache=None, pos=None):
    """x: (B,S,D). kv_cache: (k, v[, k_scale, v_scale]) of (B,Smax,Hkv,hd),
    written at ``pos`` in place and then read (int8 + scales when
    quantized)."""
    B, S, D = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta,
                   cfg.mrope_sections)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta,
                   cfg.mrope_sections)
    v = v.reshape(B, S, Hkv, hd)
    scales = {}
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
    out = A.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_softcap, q_offset=q_offset, kv_len=kv_len,
                      **scales)
    return out.reshape(B, S, Hq * hd) @ p["wo"].to(dt)


def _attn_mlp_block(cfg: ArchConfig, p, x, positions, *, window, kv_cache=None,
                    pos=None, causal=True):
    h = _attn(cfg, p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps),
              positions, window=window, causal=causal, kv_cache=kv_cache, pos=pos)
    if cfg.sandwich_norm:
        h = rms_norm(h, p["ln_attn_post"], cfg.norm_eps)
    x = x + h
    h = F.mlp(p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps), cfg.mlp_act)
    if cfg.sandwich_norm:
        h = rms_norm(h, p["ln_mlp_post"], cfg.norm_eps)
    return x + h


def _layer_windows(cfg: ArchConfig, n: int) -> list[int]:
    """Per-layer attention window: gemma2 alternates local (even layers) and
    global; everyone else is global."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else NO_WINDOW for i in range(n)]
    return [NO_WINDOW] * n


def _run_layers(cfg: ArchConfig, stacked, x, positions, *, kv_cache=None,
                pos=None, causal=True):
    """The attn + mlp stack, layer by layer. kv_cache: stacked (L, ...)
    tensors, layer i's slices written in place."""
    n = next(_leaves(stacked)).shape[0]
    for i, window in enumerate(_layer_windows(cfg, n)):
        kv = None if kv_cache is None else tuple(t[i] for t in kv_cache)
        x = _attn_mlp_block(cfg, _layer(stacked, i), x, positions, window=window,
                            kv_cache=kv, pos=pos, causal=causal)
    return x


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(ACT_DTYPE)
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


def forward_core(cfg: ArchConfig, params, x, positions, *, cache=None, pos=0):
    """Runs the body stack. Returns (hidden, cache, aux_loss); the cache is
    the one given, updated in place (None without one)."""
    _require_dense(cfg)
    if cache is None:
        kv = None
    elif "k_scale" in cache:
        kv = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    else:
        kv = (cache["k"], cache["v"])
    x = _run_layers(cfg, params["layers"], x, positions, kv_cache=kv, pos=pos)
    return x, cache, 0.0


def make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=ACT_DTYPE,
               kv_dtype=None, device=None) -> dict:
    """Zeroed stacked KV cache (L, B, max_len, Hkv, hd) on ``device`` (None:
    the card); ``kv_dtype="int8"`` adds per-(token, head) f32 scales."""
    _require_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def grow_cache(cache: dict, max_len: int) -> dict:
    """A new cache of ``max_len`` slots whose first slots hold ``cache``'s
    (its entries keep their dtypes: bf16, or int8 with their scales): how a
    prefill's cache, sized to the prompt, becomes one that decode can extend.
    The reference's tests grow theirs the same way (tests/test_arch_smoke.py)."""
    out = {}
    for key, t in cache.items():
        if max_len < t.shape[2]:
            raise ValueError(f"cannot grow a cache of {t.shape[2]} slots to {max_len}")
        out[key] = torch.zeros(t.shape[:2] + (max_len,) + t.shape[3:], dtype=t.dtype,
                               device=t.device)
        out[key][:, :, :t.shape[2]] = t
    return out


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"].device
    return torch.as_tensor(tokens, device=dev).long()


def prefill(cfg: ArchConfig, params, batch: dict):
    """Full-sequence forward that fills a new cache of the prompt's length;
    returns (last_logits (B, 1, V) f32, cache). ``batch["tokens"]`` is a
    (B, S) array or tensor."""
    _require_dense(cfg)
    tokens = _tokens(params, batch["tokens"])
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions_for(cfg, B, S, device=x.device)
    cache = make_cache(cfg, B, S, device=x.device)
    h, cache, _ = forward_core(cfg, params, x, positions, cache=cache, pos=0)
    h = rms_norm(h[:, -1:], params["ln_final"], cfg.norm_eps)
    return _logits(cfg, params, h), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One decode step: tokens (B, 1), ``cache`` holds ``pos`` valid entries
    and takes the new one at ``pos`` (in place). Returns (logits (B, 1, V)
    f32, cache)."""
    _require_dense(cfg)
    tokens = _tokens(params, tokens)
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x, cache, _ = forward_core(cfg, params, x, positions, cache=cache, pos=pos)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
