"""llama3.2-3b [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
        rope_theta=500000.0, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        rope_theta=500000.0, tie_embeddings=True, remat="none")
