"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — partial RoPE, GQA [hf:THUDM/glm-4-9b]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13_696,
        vocab=151_552, head_dim=128,
        partial_rotary=0.5, qkv_bias=True,
        fsdp=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, fsdp=False,
        dtype="float32", param_dtype="float32", remat=False)
