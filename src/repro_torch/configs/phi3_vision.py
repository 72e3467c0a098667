"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct].
The CLIP frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, n_patches, d_model) prepended to the text sequence."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab=32_064, head_dim=96,
        frontend="patches", n_frontend_tokens=256,
        fsdp=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_frontend_tokens=8, fsdp=False,
        dtype="float32", param_dtype="float32", remat=False)
