"""Config registry of the port: ``get_config(arch_id)``.

The port holds the paper's own model (``har-mlp``) and the model-zoo
architectures it serves: ``falcon-mamba-7b`` (Mamba-1), ``granite-3-8b``
(GQA) and the MoE family, ``deepseek-moe-16b``, ``moonshot-v1-16b-a3b`` and
``deepseek-v2-lite-16b`` (MLA), and the dense GQA models with other RoPE
variants and head dims: ``chatglm3-6b`` (half RoPE), ``stablelm-12b``
(head dim 160) and ``qwen2-vl-2b`` (M-RoPE and the vision stub), the
hybrid ``jamba-v0.1-52b`` (Mamba-1 and GQA layers, each followed by a dense
or an MoE FFN) and the encoder-decoder ``whisper-tiny`` (the audio stub):
every architecture of the JAX package.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig, get_shape

_ARCH_MODULES = {
    "har-mlp": "repro_torch.configs.har_mlp",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def list_archs() -> list[str]:
    """The model zoo's architectures (every one but the FL MLP)."""
    return [k for k in _ARCH_MODULES if k != "har-mlp"]


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).config


__all__ = ["ModelConfig", "InputShape", "SHAPES", "get_shape", "get_config", "list_archs"]
