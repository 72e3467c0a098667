"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596].
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, T, d_model); the assigned numbers describe the transformer
backbone (12 encoder + 12 decoder layers)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, n_encoder_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=256_206, head_dim=64,
        act="gelu", frontend="frames",
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256,
        dtype="float32", param_dtype="float32", remat=False)
