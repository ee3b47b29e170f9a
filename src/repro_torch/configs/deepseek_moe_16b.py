"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066] (DeepSeekMoE). First layer dense; standard GQA
attention (MHA since kv=16=H), head_dim 128: its prefill runs
flash_attention at D = 128, G = 1. A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408 * 8,           # dense-layer FFN width (10944-ish in the release)
    vocab_size=102400,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense=1,
    attn_type="gqa",
    head_dim=128,
    source="arXiv:2401.06066",
)
