"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free (mamba-1 arch),
d_ff=0, vocab=65024, ssm_state=16. [arXiv:2410.05355]

Pure Mamba-1 stack: in_proj -> causal depthwise conv -> selective scan ->
gated out_proj, RMSNorm pre-norm. No attention anywhere: ssm_scan is the
hot kernel. A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    attn_type="none",
    ssm=True,
    attn_period=0,           # no attention layers at all
    d_state=16,
    d_conv=4,
    expand=2,
    source="arXiv:2410.05355",
)
