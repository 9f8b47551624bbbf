"""Host-to-device copies' share of the device's busy time in the traced
window (the slabs' copies). Moves serve_rows_per_s."""

from kpcabench.metrics import ops_share_pct


def read(ctx):
    return ops_share_pct(ctx, lambda name: name.startswith("Memcpy HtoD"))
