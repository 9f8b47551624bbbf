"""seamless-m4t-large-v2 [audio] 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf]. The speech
frontend is a STUB: input_specs() provides precomputed frame embeddings."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2", family="audio", n_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
        head_dim=64, is_encdec=True, n_enc_layers=24, enc_seq=4096,
        frontend="audio_stub", rope_theta=10000.0)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2-smoke", family="audio", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        head_dim=16, is_encdec=True, n_enc_layers=2, enc_seq=16,
        frontend="audio_stub", rope_theta=10000.0, remat="none")
