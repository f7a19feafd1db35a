"""Architecture configuration schema (the port's copy of ``repro.configs.base``).

One ``ArchConfig`` per architecture of the registry (``configs/__init__``).
The fields, defaults and ``reduced()`` are the reference's, field for field;
the one difference is that ``param_dtype`` returns a torch dtype.
``reduced()`` gives the CPU-test variant (<= 2 layers, d_model <= 256,
<= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attn-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    ffn: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = True

    # sliding-window attention
    swa_window: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    dense_residual: bool = False
    first_moe_layer: int = 0
    moe_layer_period: int = 1
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # hybrid (jamba): 1 attention layer per `attn_period` blocks, rest mamba
    attn_period: int = 0
    ssm_kind: str = ""               # "" | mamba | rwkv6
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500

    # modality frontend stub (vlm/audio)
    frontend: str = "none"           # none | patch_embed | audio_frames
    frontend_tokens: int = 0

    dtype: str = "bfloat16"
    source: str = ""                 # citation

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if i < self.first_moe_layer:
            return False
        return (i - self.first_moe_layer) % self.moe_layer_period == 0

    def is_attn_layer(self, i: int) -> bool:
        if self.ssm_kind and self.attn_period == 0:
            return False
        if self.attn_period == 0:
            return True
        return i % self.attn_period == (self.attn_period - 1)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        d = min(self.d_model, 256)
        heads = self.n_heads
        kvh = self.n_kv_heads
        if heads > 0:
            heads = min(heads, 4)
            kvh = max(1, min(kvh, heads))
            while heads % kvh:
                kvh -= 1
        layers = min(self.n_layers, 2 * max(self.attn_period, 1))
        repl = {
            "n_layers": layers,
            "d_model": d,
            "n_heads": heads,
            "n_kv_heads": kvh,
            "head_dim": (d // heads) if heads else None,
            "d_ff": min(self.d_ff, 512),
            "vocab": min(self.vocab, 512),
            "n_experts": min(self.n_experts, 4),
            "top_k": min(self.top_k, 2) if self.top_k else 0,
            "moe_d_ff": min(self.moe_d_ff, 128) if self.moe_d_ff else None,
            "n_enc_layers": min(self.n_enc_layers, 2),
            "enc_seq_len": min(self.enc_seq_len, 64),
            "swa_window": min(self.swa_window, 32) if self.swa_window else None,
            "frontend_tokens": min(self.frontend_tokens, 16),
            "dtype": "float32",
        }
        return dataclasses.replace(self, **repl)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """eEnergy-Split technique config for a transformer arch."""
    client_fraction: float = 0.15
    variant: str = "vanilla"          # vanilla | ushaped
    compress_link: str = "none"       # none | int8
    fedavg_period: int = 1
