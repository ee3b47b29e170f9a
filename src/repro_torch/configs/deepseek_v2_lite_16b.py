"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434] (DeepSeek-V2; lite variant, 64 routed experts).
First layer dense FFN (DeepSeek MoE convention); MLA with decoupled RoPE
(qk_nope 128, qk_rope 64, v 128): its prefill runs flash_attention with a
q/k head dim of 192 and a v head dim of 128. A copy of the JAX package's
config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408 * 8,          # dense-layer FFN width (lite: 10944 ~ 8x expert width)
    vocab_size=102400,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense=1,
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,            # qk_nope + qk_rope
    source="arXiv:2405.04434",
)
