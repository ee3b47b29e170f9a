"""Config registry of the port: ``get_config(arch_id)``.

The port holds the paper's own model (``har-mlp``) and the two model-zoo
architectures of its serving slice (``falcon-mamba-7b``, ``granite-3-8b``);
the other architectures of the JAX package come with ROADMAP.md queue 1
item 14.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig, get_shape

_ARCH_MODULES = {
    "har-mlp": "repro_torch.configs.har_mlp",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
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
