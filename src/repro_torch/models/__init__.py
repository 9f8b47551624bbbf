"""The LM substrate's models (counterpart of ``repro.models``): the decoder
families (dense, MoE, VLM backbone) with GQA, SWA, MLA and MoE layers, the
mamba families (ssm, hybrid) and the encoder-decoder (audio), in plain
PyTorch, on one device or sharded over a device mesh (training, and
decoding with a context-parallel cache)."""

from .convert import params_from_jax
from .decoding import MeshCache
from .model import Model, build_model

__all__ = ["MeshCache", "Model", "build_model", "params_from_jax"]
