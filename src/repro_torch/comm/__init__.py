"""repro_torch.comm — wire-format compression (quantization, top-k, error
feedback) for the federated uplink. See codec.py."""

from repro_torch.comm.codec import (
    ChainedCodec,
    Codec,
    Float32Identity,
    QuantizeCodec,
    TopKCodec,
    ef_step,
    ef_steps,
    make_codec,
    roundtrip_tree,
    tree_wire_bytes,
)

__all__ = [
    "Codec",
    "Float32Identity",
    "QuantizeCodec",
    "TopKCodec",
    "ChainedCodec",
    "make_codec",
    "tree_wire_bytes",
    "roundtrip_tree",
    "ef_step",
    "ef_steps",
]
