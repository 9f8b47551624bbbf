"""deepseek-v2-236b [moe] 60L d_model=5120 128H d_ff=1536 vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=12288, vocab=102400,
        head_dim=192,                      # qk_nope 128 + qk_rope 64
        attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
        first_k_dense=1, d_ff_dense=12288, rope_theta=10000.0)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=24,
        attn_kind="mla", q_lora_rank=32, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=32,
        first_k_dense=1, d_ff_dense=128, rope_theta=10000.0, remat="none")
