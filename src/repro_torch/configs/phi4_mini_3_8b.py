"""phi4-mini-3.8b [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064, head_dim=128,
        rope_theta=10000.0, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=6, n_kv_heads=2, d_ff=96, vocab=512, head_dim=8,
        rope_theta=10000.0, tie_embeddings=True, remat="none")
