"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, Mamba+attention 1:7 interleave (1 attn layer per 8, at offset 4),
MoE 16 experts top-2 every other layer. [arXiv:2403.19887]

Each layer is a Mamba-1 mixer (its prefill runs ssm_scan at d_inner 8,192
and d_state 16) or, at index 4 of each 8-layer period, GQA attention
(flash_attention at D = 128, G = 4); a dense SwiGLU or, on the odd layers,
an MoE with no shared experts follows either mixer. A copy of the JAX
package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=True,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    moe_offset=1,            # MoE on odd layers (Jamba: every other, starting 1)
    attn_type="gqa",
    head_dim=128,
    ssm=True,
    attn_period=8,
    attn_offset=4,           # attention at layer idx % 8 == 4 (paper Fig. 2)
    d_state=16,
    d_conv=4,
    expand=2,
    source="arXiv:2403.19887",
)
