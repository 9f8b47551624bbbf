"""llama3-405b [dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783; unverified]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense", n_layers=126, d_model=16384,
        n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256, head_dim=128,
        rope_theta=500000.0)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b-smoke", family="dense", n_layers=3, d_model=96,
        n_heads=8, n_kv_heads=2, d_ff=192, vocab=512, head_dim=12,
        rope_theta=500000.0, remat="none")
