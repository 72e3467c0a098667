"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 (+1 shared expert, early
fusion) [hf:meta-llama/Llama-4 family].

Assigned config is used verbatim (all layers MoE at d_ff=8192 per expert);
optimizer defaults to Adafactor (factored second moment) — Adam moments for
~0.8T params do not fit a 256-chip v5e pod (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab=202_048, head_dim=128,
        n_experts=128, top_k=1, n_shared_experts=1, capacity_factor=1.25,
        rope_theta=500_000.0,
        fsdp=True, optimizer="adafactor",
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256, n_experts=8, top_k=1, fsdp=False,
        dtype="float32", param_dtype="float32", remat=False)
