"""mixtral-8x22b [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088; hf]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, head_dim=128,
        attn_kind="swa", window=4096,
        n_experts=8, top_k=2, d_ff_expert=16384, rope_theta=1000000.0)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        attn_kind="swa", window=16,
        n_experts=4, top_k=2, d_ff_expert=128, rope_theta=1000000.0,
        remat="none")
