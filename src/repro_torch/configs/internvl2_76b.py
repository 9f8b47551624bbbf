"""internvl2-76b [vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2 backbone [arXiv:2404.16821;
unverified]. Vision frontend is a STUB: input_specs() provides precomputed
patch embeddings (frontend_seq positions at d_model)."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, head_dim=128,
        frontend="vision_stub", frontend_seq=1024, rope_theta=500000.0)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        frontend="vision_stub", frontend_seq=8, rope_theta=500000.0,
        remat="none")
