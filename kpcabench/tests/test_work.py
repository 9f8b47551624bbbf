"""The roofline's counts for known shapes, and the peaks they use."""

import pytest

from kpcabench.work import PEAKS, admm_step, bound_s, fit, gram, lm_hybrid, \
    project, share_pct

J80 = dict(nodes=80, samples_per_node=100, features=784, hops=2,
           iterations=30)


def test_peaks():
    assert PEAKS["tf32_flops_per_s"] == 495e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert PEAKS["bf16_flops_per_s"] == 989e12


def test_gram_block():
    assert gram.block(2, 3, 5) == (60.0, 4 * (10 + 15 + 6))
    assert gram.block(4, 4, 5, same=True) == (160.0, 4 * (20 + 16))


def test_gram_fit_is_the_pooled_gram_once():
    ops, nbytes = gram.fit(J80)
    assert ops == 2.0 * 8000 * 8000 * 784
    assert nbytes == 4 * (8000 * 784 + 8000 * 8000)
    assert bound_s(ops, nbytes) == pytest.approx(ops / 495e12)


def test_admm_step_call():
    ops, nbytes = admm_step.call(80, 100, 5)
    assert ops == 6.0 * 80 * 100 * 100
    reads = 2 * 80 * 100 * 100 + 80 * 100 + 2 * 80 * 100 * 5 + 80 * 5
    writes = 2 * 80 * 100 + 80 * 100 * 5
    assert nbytes == 4 * (reads + writes)
    f_ops, f_bytes = admm_step.fit(J80)
    assert (f_ops, f_bytes) == (30 * ops, 30 * nbytes)
    # bound by the bytes: V and K read once a call
    assert bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_project_rows_count_rows_not_slabs():
    ops, nbytes = project.rows(1000, 8000, 784, 1)
    assert ops == 2.0 * 1000 * 8000 * 786
    assert nbytes == 4 * (1000 * 785 + 8000 * 785)
    assert project.rows(2000, 8000, 784)[0] == 2 * ops


def test_fit_ops_include_the_gram_and_the_iterations():
    per_node = 4 * 100 * 100 * 5 + 2 * 500 ** 2 + 2 * 500 + 6 * 100 * 100
    assert fit.ops(J80) == gram.fit(J80)[0] + 30 * 80 * per_node


def test_share():
    assert share_pct(495e12, 0, 2.0) == pytest.approx(50.0)
    assert share_pct(1.0, 1.0, 0.0) is None


ZAMBA2 = dict(d_model=2048, d_inner=4096, ssm_state=64, ssm_head_dim=64,
              n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, n_layers=38,
              attn_every=6, d_conv=4, vocab=32000)


def test_hybrid_step_ops():
    mamba = (2 * 2048 * (2 * 4096 + 2 * 64 + 64) + 2 * 4096 * 2048
             + 2 * 4 * (4096 + 128) + 4 * 4096 * 64)
    shared = 2 * 2048 * 64 * 128 + 4 * 32 * 64 * 2049 / 2 + 6 * 2048 * 8192
    per_token = 38 * mamba + 6 * shared + 2 * 2048 * 32000
    assert lm_hybrid.forward_per_token(ZAMBA2, 2048) == pytest.approx(
        per_token)
    assert lm_hybrid.step_ops(ZAMBA2, 4, 2048) == pytest.approx(
        3 * 8192 * per_token)
    # about 6 x the 1.2e9 weights a token, with attention's share
    assert 7e9 < 3 * per_token < 1e10
