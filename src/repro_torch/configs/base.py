"""Unified architecture configuration.

One dataclass covers all 10 assigned families (dense / MoE / MLA / VLM /
audio enc-dec / hybrid / SSM). Each ``configs/<id>.py`` exports
``config()`` (the exact published configuration) and ``smoke_config()``
(a reduced same-family config for CPU tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # misc transformer knobs
    act: str = "silu"
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_theta: float = 500000.0
    tie_embeddings: bool = False

    # attention
    attn_kind: str = "full"          # full | swa | mla | none
    window: int = 4096               # SWA window
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0           # deepseek: first layer(s) dense
    capacity_factor: float = 1.25
    d_ff_dense: int = 0              # dense-layer ffn width when mixed

    # SSM (mamba)
    mamba_version: int = 0           # 0 = none, 1, 2
    ssm_state: int = 0
    d_inner: int = 0
    d_conv: int = 4
    dt_rank: int = 0                 # mamba1
    ssm_head_dim: int = 64           # mamba2
    ssm_chunk: int = 64

    # hybrid (zamba2): shared attention block applied every N mamba blocks
    attn_every: int = 0

    # encoder-decoder (seamless)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 4096              # stub frame-embedding length

    # modality frontend stub (vlm / audio): prefix of precomputed embeddings
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_seq: int = 0            # prefix length within the text sequence

    # implementation knobs (perf-tunable; see EXPERIMENTS.md §Perf)
    attention_impl: str = "einsum"   # einsum | chunked
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # SWA banding (§Perf hillclimb): chunked attention skips (q, kv) chunk
    # pairs entirely outside the sliding window instead of masking them
    swa_banded: bool = False
    # sequence-parallel attention (§Perf hillclimb): shard the query seq dim
    # over "model" inside attention — the TP fallback when head counts don't
    # divide the model axis (llama3.2/phi4: 24 heads on a 16-way axis would
    # otherwise replicate all attention compute)
    attn_seq_shard: bool = False
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    # cost-measurement mode: fully unroll every internal lax.scan so the XLA
    # cost model (which counts while-loop bodies once) sees all iterations.
    # Only used by reduced-size dry-run cost variants — never at full scale.
    unroll_scans: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # sharding overrides merged into distributed.sharding.default_rules
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.mamba_version > 0 and self.attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token long-context decode shape?"""
        return self.mamba_version > 0 or self.attn_kind == "swa"

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        e, l = self.d_model, self.n_layers
        emb = self.vocab * e * (1 if self.tie_embeddings else 2)
        if self.mamba_version == 1 and self.attn_every == 0:
            # pure mamba1 stack (falcon-mamba)
            per = (e * 2 * self.d_inner + self.d_inner * self.d_conv
                   + self.d_inner * (self.dt_rank + 2 * self.ssm_state)
                   + self.dt_rank * self.d_inner
                   + self.d_inner * self.ssm_state + self.d_inner
                   + self.d_inner * e)
            return emb + l * per
        if self.mamba_version == 2 and self.attn_every > 0:
            # hybrid (zamba2): mamba2 blocks + ONE shared attn+mlp block
            n_h = self.d_inner // self.ssm_head_dim
            per_m = (e * (2 * self.d_inner + 2 * self.ssm_state + n_h)
                     + self.d_inner * self.d_conv + self.d_inner * e)
            shared = self._attn_params() + 3 * e * self.d_ff
            return emb + l * per_m + shared
        attn = self._attn_params()
        if self.is_moe:
            moe = (3 * self.n_experts * e * self.d_ff_expert
                   + 3 * self.n_shared_experts * e * self.d_ff_expert
                   + e * self.n_experts)
            dense_ff = 3 * e * (self.d_ff_dense or self.d_ff)
            ff = (l - self.first_k_dense) * moe + self.first_k_dense * dense_ff
        else:
            ff = l * 3 * e * self.d_ff
        enc = 0
        if self.is_encdec:
            # encoder stack + decoder cross-attention
            per_enc = (attn // max(l, 1)) + 3 * e * self.d_ff
            enc = self.n_enc_layers * per_enc + l * (attn // max(l, 1))
        return emb + attn + ff + enc

    def _attn_params(self) -> int:
        e, l = self.d_model, self.n_layers
        if self.attn_kind == "mla":
            per = (e * self.kv_lora_rank
                   + e * self.qk_rope_dim
                   + (e * self.q_lora_rank + self.q_lora_rank * self.n_heads
                      * (self.qk_nope_dim + self.qk_rope_dim)
                      if self.q_lora_rank else
                      e * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                   + self.kv_lora_rank * self.n_heads
                   * (self.qk_nope_dim + self.v_head_dim)
                   + self.n_heads * self.v_head_dim * e)
        else:
            per = (e * self.n_heads * self.head_dim
                   + 2 * e * self.n_kv_heads * self.head_dim
                   + self.n_heads * self.head_dim * e)
        n_attn = l if self.attn_every == 0 else 1
        return n_attn * per

    def active_params(self) -> int:
        """Active-per-token parameters (MoE-aware) for MODEL_FLOPS = 6*N*D."""
        if not self.is_moe:
            return self.n_params()
        e, l = self.d_model, self.n_layers
        emb = self.vocab * e * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        n_moe = l - self.first_k_dense
        act_ff = n_moe * 3 * e * self.d_ff_expert * (self.top_k
                                                     + self.n_shared_experts) \
            + self.first_k_dense * 3 * e * (self.d_ff_dense or self.d_ff)
        return emb + attn + act_ff
