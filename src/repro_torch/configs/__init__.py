"""Config registry of the port: ``get_config(arch_id)``.

The port holds the paper's own model (``har-mlp``) and the model-zoo
architectures it serves: ``falcon-mamba-7b`` (Mamba-1), ``granite-3-8b``
(GQA) and the MoE family, ``deepseek-moe-16b``, ``moonshot-v1-16b-a3b`` and
``deepseek-v2-lite-16b`` (MLA). The other architectures of the JAX package
come with ROADMAP.md queue 1 item 14.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig, get_shape

_ARCH_MODULES = {
    "har-mlp": "repro_torch.configs.har_mlp",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP.md queue 1 item 14, "
            f"model zoo); have {sorted(_ARCH_MODULES)}"
        )
    return importlib.import_module(_ARCH_MODULES[arch]).config


__all__ = ["ModelConfig", "InputShape", "SHAPES", "get_shape", "get_config"]
