"""Architecture registry (counterpart of ``repro.configs``): the 10 assigned
architectures, each with its published configuration and a reduced smoke
configuration. Shape presets only: no weights."""

from importlib import import_module

from .base import ArchConfig
from .shapes import SHAPES, ShapeSpec, applicable, concrete_train_batch, \
    decode_specs, train_batch_specs

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "llama3-405b": "llama3_405b",
    "qwen3-32b": "qwen3_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x22b": "mixtral_8x22b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-1.2b": "zamba2_1_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    mod = import_module(f".{_MODULES[name]}", __package__)
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ARCH_NAMES", "ArchConfig", "SHAPES", "ShapeSpec", "applicable",
           "concrete_train_batch", "decode_specs", "get_config",
           "train_batch_specs"]
