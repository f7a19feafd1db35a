"""Architecture registry: the port's copy of the ten ``repro.configs`` entries.

``get_config(name)`` returns the full published ArchConfig;
``get_config(name).reduced()`` the CPU-test variant. The reference keeps one
module per architecture; here they are data in one place, under the same
names (``repro_torch.configs.smollm_135m`` is ``repro.configs.smollm_135m``).
"""
from .base import INPUT_SHAPES, ArchConfig, InputShape, SplitConfig

qwen1_5_32b = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
pixtral_12b = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=160,
    rope_theta=1_000_000.0,
    frontend="patch_embed", frontend_tokens=1024,
    source="hf:mistralai/Pixtral-12B-2409",
)
whisper_tiny = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    norm="layernorm", ffn="gelu",
    enc_dec=True, n_enc_layers=4, enc_seq_len=1500,
    frontend="audio_frames",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
arctic_480b = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, dense_residual=True,
    moe_d_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base",
)
h2o_danube_1_8b = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    swa_window=4096,
    source="arXiv:2401.16818",
)
deepseek_moe_16b = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_moe_layer=1,
    source="arXiv:2401.06066",
)
smollm_135m = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
jamba_1_5_large_398b = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_layer_period=2,
    attn_period=8, ssm_kind="mamba", ssm_state_dim=16, ssm_expand=2,
    swa_window=4096,
    source="arXiv:2403.19887",
)
rwkv6_7b = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    head_dim=64,
    d_ff=14336, vocab=65536,
    ssm_kind="rwkv6", attn_period=0,
    source="arXiv:2404.05892",
)
yi_9b = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        qwen1_5_32b, pixtral_12b, whisper_tiny, arctic_480b,
        h2o_danube_1_8b, deepseek_moe_16b, smollm_135m,
        jamba_1_5_large_398b, rwkv6_7b, yi_9b,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "SplitConfig",
           "ARCHS", "get_config"]
