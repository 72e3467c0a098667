"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
        vocab=262_144, head_dim=256,
        local_window=512, local_global_period=6,   # 5 local : 1 global
        rope_theta=1_000_000.0,
        tied_embeddings=True, act="gelu",
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, local_window=8,
        dtype="float32", param_dtype="float32", remat=False)
