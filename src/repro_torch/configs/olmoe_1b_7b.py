"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
        vocab=50_304, head_dim=128,
        n_experts=64, top_k=8, capacity_factor=1.25,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=256, n_experts=8, top_k=2,
        dtype="float32", param_dtype="float32", remat=False)
