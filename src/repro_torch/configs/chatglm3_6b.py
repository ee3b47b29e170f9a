"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024. 2d RoPE (rotary on half the head dims), GQA. [arXiv:2406.12793]

Its prefill runs flash_attention at D = 128 with G = 16 (32 q heads over 2
kv heads). A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    attn_type="gqa",
    rope_variant="half",
    head_dim=128,
    source="arXiv:2406.12793",
)
