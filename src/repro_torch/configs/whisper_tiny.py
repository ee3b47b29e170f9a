"""whisper-tiny [audio] — 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 (padded 51968). [arXiv:2212.04356]

The mel-spectrogram + conv frontend is a stub: the batch provides
precomputed frame embeddings (B, 1500, 384) — 30 s of audio after the
stride-2 conv. The transformer backbone (bidirectional encoder, causal
decoder with cross-attention) is implemented in ``models/whisper.py``.
Decoder context 448 tokens (paper).

Its prefill runs flash_attention at D = 64, G = 1: non-causal over the
1,500 frames in the encoder, non-causal from S <= 448 decoder queries over
T = 1,500 frames in the cross-attention, causal in the decoder's
self-attention; a decode step runs the cross-attention again, one query
over the 1,500 frames. A copy of the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    attn_type="gqa",
    rope_variant="full",     # whisper uses learned abs pos; we add RoPE-free learned emb
    head_dim=64,
    encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    max_decoder_seq=448,
    source="arXiv:2212.04356",
)
