"""Architecture configs (the assigned 10 x 4 grid), as in ``repro.configs.base``.

Every architecture is a selectable config; ``reduced()`` yields the
family-preserving smoke-test configuration. The reference's
``input_specs`` (shape stand-ins for the distributed dry-run) waits for the
dry-run's port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention features
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: int = 0     # gemma2 local layers
    alt_local_global: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    mlp_act: str = "swiglu"
    sandwich_norm: bool = False
    embed_scale: bool = False
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    expert_dff: int = 0
    moe_impl: str = "sorted"
    # ssm (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0         # zamba2: shared attn block after every N mamba layers
    # xlstm
    slstm_every: int = 0        # 1 sLSTM per N layers (rest mLSTM)
    proj_factor: float = 2.0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    cross_len: int = 1500       # decode-time cross-attention KV length
    # vlm
    n_vision_tokens: int = 0
    mrope_sections: tuple[int, ...] = ()
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: bool = True
    sub_quadratic: bool = False  # eligible for long_500k
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def supports(self, shape: str) -> bool:
        if shape == "long_500k":
            return self.sub_quadratic
        return True

    def skip_reason(self, shape: str) -> str:
        if shape == "long_500k" and not self.sub_quadratic:
            return "full quadratic attention — long_500k skipped per spec"
        return ""

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke config (small layers/width/vocab)."""
        changes: dict = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads or 1)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=64 if self.sliding_window else 0,
            remat=False,
        )
        if self.n_experts:
            changes.update(n_experts=8, moe_top_k=min(2, self.moe_top_k),
                           expert_dff=64)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=32)
        if self.attn_every:
            changes.update(attn_every=2, n_layers=4)
        if self.slstm_every:
            changes.update(slstm_every=2, n_layers=4)
        if self.n_enc_layers:
            changes.update(n_enc_layers=2, cross_len=32)
        if self.n_vision_tokens:
            changes.update(n_vision_tokens=16)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401 — populate registry
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs.all_archs  # noqa: F401
    return sorted(_REGISTRY)
