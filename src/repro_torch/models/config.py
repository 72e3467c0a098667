"""Model configuration for the assigned architecture zoo.

A verbatim copy of ``repro/models/config.py`` (the port imports nothing of
the JAX package)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0   # fraction of head_dim rotated
    local_window: int = 0         # sliding-window size for local layers
    local_global_period: int = 0  # e.g. 6 => layers 0..4 local, 5 global
    tied_embeddings: bool = False
    act: str = "swiglu"           # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"   # scatter | onehot | sort

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # hybrid (Zamba2-style shared attention block)
    shared_attn_period: int = 0   # apply shared attn after every N ssm layers

    # encoder-decoder
    n_encoder_layers: int = 0

    # modality frontend stubs
    frontend: str = ""            # "" | "patches" | "frames"
    n_frontend_tokens: int = 0    # prepended embedding tokens (vlm)

    # numerics / distribution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    fsdp: bool = False            # shard params over the data axis too
    # training-phase layout for kv-nondivisible GQA archs: replicate attn
    # weights over "model" + batch-parallel attention compute (§Perf);
    # prefill/decode keep head-sharded weights (forward-only replication is
    # mild and backward score all-reduces don't exist there)
    attn_param_replication: bool = False
    remat: bool = True
    optimizer: str = "adamw"      # adamw | adafactor
    # long-context capability: decode beyond ~128k is only claimed for
    # sub-quadratic (SSM/hybrid) families
    sub_quadratic: bool = False
    # serving: "int8" stores the KV cache quantised (per-token-per-head
    # scales) — halves decode's weight/cache memory-streaming term (§Perf)
    kv_cache_dtype: str = ""

    @property
    def hd(self) -> int:
        if self.n_heads == 0:           # attention-free (pure SSM) archs
            return self.head_dim or 1
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """40-cell matrix skip rules (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is a full-attention arch")
    return True, ""
