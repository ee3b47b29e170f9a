"""moonshot-v1-16b-a3b — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 routed top-6 (+2 shared, Moonlight/DeepSeek-V3 style).
[hf:moonshotai/Moonlight-16B-A3B]

deepseek-moe-16b's layer structure (a dense first layer, then MoE layers)
at 48 layers and a vocabulary of 163,840. A copy of the JAX package's
config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408 * 8,
    vocab_size=163840,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense=1,
    attn_type="gqa",
    head_dim=128,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
