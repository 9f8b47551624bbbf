"""falcon-mamba-7b [ssm] 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 architecture [arXiv:2410.05355; unverified]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, head_dim=64,
        attn_kind="none", mamba_version=1, ssm_state=16, d_inner=8192,
        d_conv=4, dt_rank=256, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=512, head_dim=16,
        attn_kind="none", mamba_version=1, ssm_state=8, d_inner=128,
        d_conv=4, dt_rank=8, ssm_chunk=8, tie_embeddings=True, remat="none")
