"""har-mlp — the paper's own model (§4.2): MLP, 3 hidden layers x 256 units,
SGD + sparse categorical cross-entropy, for the HAR datasets.
[10.1016/j.adhoc.2024.103462]

Not part of the assigned-architecture pool; used by the FL reproduction and
examples. Kept in the registry so `--arch har-mlp` selects the paper's own
experiment configuration.
"""

from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="har-mlp",
    family="mlp",
    n_layers=4,       # 3 hidden + softmax head — the paper's Eq. 9 total
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    attn_type="none",
    source="10.1016/j.adhoc.2024.103462",
)


def fl_defaults():
    """The paper's headline experiment recipe as a nested FLConfig:
    ACSP-FL selection + decay, DLD partial sharing, SGD local training.
    Callers tailor it with ``dataclasses.replace`` on the sub-configs
    (e.g. ``replace(cfg, train=replace(cfg.train, rounds=30))``)."""
    from repro_torch.configs.base import (
        CodecConfig, PersonalizationConfig, SelectionConfig, TrainConfig,
    )
    from repro_torch.fl.api import FLConfig

    return FLConfig(
        selection=SelectionConfig(strategy="acsp-fl", decay=0.01),
        personalization=PersonalizationConfig(mode="dld"),
        codec=CodecConfig(spec="float32"),
        train=TrainConfig(rounds=100, epochs=2, batch_size=32, lr=0.1),
    )
