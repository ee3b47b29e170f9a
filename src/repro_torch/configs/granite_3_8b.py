"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 (padded to 49408). [hf:ibm-granite/granite-3.0-8b-base]

Full RoPE, SwiGLU, head_dim 128: flash_attention is the hot kernel of its
prefill. A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    attn_type="gqa",
    head_dim=128,
    source="hf:ibm-granite/granite-3.0-8b-base",
)
