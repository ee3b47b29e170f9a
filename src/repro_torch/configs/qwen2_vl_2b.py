"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE (t/h/w sections), dynamic resolution. [arXiv:2409.12191]

The vision frontend is a stub: the batch provides
precomputed patch embeddings (B, n_vision_tokens, d_model); the language
decoder (built here) consumes them prepended to the text tokens, with
M-RoPE (t, h, w) position triples.

Its prefill runs flash_attention at D = 128 with G = 6 (12 q heads over 2
kv heads). A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    attn_type="gqa",
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    head_dim=128,
    frontend="vision_stub",
    n_vision_tokens=1024,     # e.g. one 1024-patch image per sequence
    source="arXiv:2409.12191",
)
