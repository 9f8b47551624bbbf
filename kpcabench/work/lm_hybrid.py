"""The hybrid family's training work: the products of one step's forward
and backward pass, counted from the configuration's widths (a multiply-add
is two operations; the backward pass twice the forward's; the layers the
backward pass recomputes are not counted).

Forward, a token: each Mamba-2 layer's input projection (2 E (2 d_inner +
2 N + heads)) and output projection (2 d_inner E), its depthwise
convolution (2 K (d_inner + 2 N)) and the SSD recurrence's least work
(the state's update and read-out, 4 d_inner N: what the linear scan needs,
not what the chunked form computes); each application of the shared
block: the q, k, v and o projections (2 E D (2 H + 2 H_kv)), causal
attention (scores and the weighted sum over the (L + 1) / 2 keys a
position sees on average, 4 H D (L + 1) / 2) and the gated MLP (6 E F);
the logits (2 E V)."""

from __future__ import annotations


def forward_per_token(cfg: dict, seq: int) -> float:
    e, di, n = cfg["d_model"], cfg["d_inner"], cfg["ssm_state"]
    heads = di // cfg["ssm_head_dim"]
    h, hk, d, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], \
        cfg["d_ff"]
    mamba = (2.0 * e * (2 * di + 2 * n + heads) + 2.0 * di * e
             + 2.0 * cfg["d_conv"] * (di + 2 * n) + 4.0 * di * n)
    shared = (2.0 * e * d * (2 * h + 2 * hk) + 4.0 * h * d * (seq + 1) / 2
              + 6.0 * e * f)
    applications = cfg["n_layers"] // cfg["attn_every"]
    return (cfg["n_layers"] * mamba + applications * shared
            + 2.0 * e * cfg["vocab"])


def step_ops(cfg: dict, batch: int, seq: int) -> float:
    """Operations of one training step of ``batch`` x ``seq`` tokens."""
    return 3.0 * batch * seq * forward_per_token(cfg, seq)
