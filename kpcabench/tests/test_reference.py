"""The frozen generator and the plain reference against the plain math at
a tiny size, and the reference against the port's own CPU path."""

import math

import numpy as np
import pytest
import torch

from kpcabench import checks, data, reference

CFG = dict(nodes=6, samples_per_node=9, features=784, hops=2,
           iterations=30, rho1=100.0, kernel="rbf", center="global",
           rho2=dict(boundaries=[0, 10, 20], values=[10.0, 50.0, 100.0]),
           data=dict(n_classes=4, noise=0.05, dominant=3.0))


def test_generator_is_seeded_and_in_range():
    a = data.fit_pool(data.generator(2 ** 31 + 5, "cpu"), 3, 4, 5, 784,
                      CFG["data"], "cpu", chunk=2)
    b = data.fit_pool(data.generator(2 ** 31 + 5, "cpu"), 3, 4, 5, 784,
                      CFG["data"], "cpu", chunk=2)
    c = data.fit_pool(data.generator(7, "cpu"), 3, 4, 5, 784,
                      CFG["data"], "cpu", chunk=2)
    assert a.shape == (3, 4, 5, 784) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0


def test_rows_follow_the_generator_formula():
    """One population's rows against the formula written out row by row
    from the same draws."""
    gen = data.generator(3, "cpu")
    pop = data.population(gen, 1, 784, 4, "cpu")
    state = gen.get_state()
    x = data.rows(gen, pop, 8)[0]
    gen.set_state(state)
    t = torch.rand((1, 8), generator=gen) * 2 * math.pi
    sec = torch.tanh(torch.randn((1, 8, 6), generator=gen)) * 0.4
    noise = torch.randn((1, 8, 784), generator=gen) * (0.05 * 28 / 4)
    order = torch.argsort(torch.rand((1, 8), generator=gen), dim=1)[0]
    want = []
    for i in range(8):
        dom = torch.tensor([4.0 * math.cos(t[0, i]), 1.5 * math.sin(
            2 * t[0, i])])
        z = dom @ pop["w_dom"][0] + sec[0, i] @ pop["w_sec"][0] \
            + pop["offs"][0, i % 4] + noise[0, i]
        want.append(1.0 / (1.0 + torch.exp(-z * 8.0 / 28.0)))
    want = torch.stack(want)[order]
    assert torch.allclose(x, want, atol=1e-5)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10, -3.14159], dtype=torch.float32)
    got = reference.round_tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
    mant = got.view(torch.int32) & 0x1FFF
    assert int(mant.abs().sum()) == 0
    assert abs(float(got[4]) + 3.14159) < 2 ** -9


def test_gram_and_gamma_against_numpy():
    rng = np.random.default_rng(0)
    x = rng.random((300, 784))
    xt = torch.as_tensor(x)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    sub = d2[:256, :256] + np.eye(256) * d2[:256, :256].max()
    gamma = 1.0 / np.median(sub)
    got = reference.median_gamma(xt, reference.EXACT)
    assert abs(float(got) - gamma) <= 1e-12 * gamma
    k = reference.rbf(xt[:20], xt[20:50], got, reference.EXACT)
    assert np.allclose(k.numpy(), np.exp(-gamma * d2[:20, 20:50]),
                       rtol=1e-12, atol=0)


def test_ring_slots():
    src, rsl = reference.ring_slots(6, 2)
    assert src[0].tolist() == [0, 4, 5, 1, 2]
    for j in range(6):
        for s in range(1, 5):
            assert src[src[j, s], rsl[j, s]] == j


def test_scores_against_numpy():
    rng = np.random.default_rng(1)
    sup, q = rng.random((50, 784)), rng.random((7, 784))
    a = rng.normal(size=50) / np.sqrt(50)
    model = reference.served_model(torch.as_tensor(sup), torch.as_tensor(a))
    g = float(model.gamma)
    k_s = np.exp(-g * ((sup[:, None] - sup[None]) ** 2).sum(-1))
    k_q = np.exp(-g * ((q[:, None] - sup[None]) ** 2).sum(-1))
    # the centred kernel of the queries against the centred support
    kc = k_q - k_q.mean(1, keepdims=True) - k_s.mean(0)[None] + k_s.mean()
    got, size = reference.scores(model, torch.as_tensor(q))
    assert np.allclose(got.numpy(), kc @ a, rtol=1e-10, atol=1e-12)
    assert (size.numpy() >= np.abs(got.numpy()) - 1e-12).all()


def port_fit(x, a0):
    """The port's fit on the CPU (its plain PyTorch path)."""
    from repro_torch.core import (KernelSpec, RhoSchedule, build_setup, oos,
                                  ring, run_admm)
    spec = KernelSpec(kind="rbf")
    setup = build_setup(x, ring(CFG["nodes"], hops=2), spec, device="cpu")
    res = run_admm(setup, n_iters=30, rho1=100.0, rho2=RhoSchedule(),
                   alpha0=a0)
    model = oos.from_decentralized(x, res.alpha, spec, gamma=setup.gamma,
                                   device="cpu")
    return res.alpha, model.row_mean_coef, model.bias


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_reference_fit_agrees_with_the_port_on_the_cpu(seed):
    gen = data.generator(seed, "cpu")
    x = data.fit_pool(gen, 1, CFG["nodes"], CFG["samples_per_node"], 784,
                      CFG["data"], "cpu")[0]
    a0 = data.alpha0(gen, 1, CFG["nodes"], CFG["samples_per_node"], "cpu")[0]
    ref = reference.fit(x, a0, CFG)
    got = checks.fit_numbers(*port_fit(x, a0), ref)
    assert got["alpha"] < 1e-3 and got["centring"] < 1e-4
    # the control (TF32 products) lands far from the reference
    ctl = reference.fit(x, a0, CFG, reference.TF32)
    bad = checks.fit_numbers(ctl.alpha, ctl.row_mean_coef, ctl.bias, ref)
    assert bad["alpha"] > 10 * got["alpha"]
