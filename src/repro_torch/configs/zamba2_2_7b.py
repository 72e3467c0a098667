"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. One shared attn+MLP block applied every 6 Mamba2
layers (DESIGN.md §7 simplification of the two-alternating-blocks scheme).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10_240,
        vocab=32_000, head_dim=80,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, ssm_groups=1,
        shared_attn_period=6,
        sub_quadratic=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
        shared_attn_period=2,
        dtype="float32", param_dtype="float32", remat=False)
