"""The 10 assigned architectures (exact full configs; sources in brackets)."""
from repro_torch.configs.base import ArchConfig, register

# [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
zamba2_1p2b = register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    attn_every=6, sub_quadratic=True,
    source="arXiv:2411.15242",
))

# [dense] qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B]
codeqwen = register(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B",
))

# [dense] llama-arch GQA [arXiv:2403.04652]
yi_9b = register(ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, rope_theta=1e6,
    source="arXiv:2403.04652",
))

# [dense] local+global alternating, logit softcap [arXiv:2408.00118]
gemma2_27b = register(ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    sliding_window=4096, alt_local_global=True,
    attn_softcap=50.0, logit_softcap=30.0,
    mlp_act="geglu", sandwich_norm=True, embed_scale=True,
    source="arXiv:2408.00118",
))

# [dense] GQA, QKV bias [arXiv:2407.10671]
qwen2_7b = register(ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
))

# [audio] enc-dec, conv frontend stubbed [arXiv:2212.04356]
whisper_medium = register(ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865, cross_len=1500,
    mlp_act="geglu", rope_theta=1e4,
    source="arXiv:2212.04356",
))

# [vlm] M-RoPE, dynamic resolution (patch frontend stubbed) [arXiv:2409.12191]
qwen2_vl_2b = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    n_vision_tokens=256, mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191",
))

# [moe] 40 experts top-8 [hf:ibm-granite/granite-3.0 family]
granite_3b = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, moe_top_k=8, expert_dff=512,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
))

# [moe] 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
granite_1b = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=32, moe_top_k=8, expert_dff=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))

# [ssm] sLSTM + mLSTM blocks [arXiv:2405.04517]
xlstm_350m = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    slstm_every=4, proj_factor=2.0, sub_quadratic=True,
    source="arXiv:2405.04517",
))

ALL = [zamba2_1p2b, codeqwen, yi_9b, gemma2_27b, qwen2_7b, whisper_medium,
       qwen2_vl_2b, granite_3b, granite_1b, xlstm_350m]
