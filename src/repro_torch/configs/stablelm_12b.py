"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family, 12B scale-up]
head_dim = 5120/32 = 160.

Its prefill runs flash_attention's bf16 kernel at (Dqk, Dv) = (160, 160),
G = 4. A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    attn_type="gqa",
    head_dim=160,
    source="hf:stabilityai/stablelm-2-12b",
)
