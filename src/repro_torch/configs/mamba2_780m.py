"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=50_280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, ssm_groups=1,
        tied_embeddings=True,
        sub_quadratic=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_headdim=16,
        ssm_chunk=16, dtype="float32", param_dtype="float32", remat=False)
