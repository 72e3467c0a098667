"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13_824,
        vocab=152_064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        fsdp=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, fsdp=False,
        dtype="float32", param_dtype="float32", remat=False)
