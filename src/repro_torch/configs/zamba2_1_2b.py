"""zamba2-1.2b [hybrid] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention block [arXiv:2411.15242;
hf]. Simplifications noted in DESIGN.md (no concat-embedding projection or
LoRA on the shared block)."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, head_dim=64,
        mamba_version=2, ssm_state=64, d_inner=4096, d_conv=4,
        ssm_head_dim=64, attn_every=6, rope_theta=10000.0,
        tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b-smoke", family="hybrid", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
        mamba_version=2, ssm_state=8, d_inner=128, d_conv=4,
        ssm_head_dim=32, attn_every=2, ssm_chunk=8, rope_theta=10000.0,
        tie_embeddings=True, remat="none")
