"""The hybrid family's plain reference against the port at the smoke
configuration on the CPU, in float32 (the port's smoke config with fp32
weights and compute): the leaves, the loss, every leaf's gradient, one
AdamW step and the probe's answers; the frozen token stream against the
port's. About 12 s alone."""

import dataclasses

import pytest
import torch

from kpcabench import lm_checks, lm_reference, reference
from kpcabench.lm_reference import hybrid
from kpcabench.tokens import Stream

WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "d_inner", "ssm_state", "d_conv", "ssm_head_dim",
          "attn_every", "rope_theta", "norm_eps", "act", "tie_embeddings")
OPT = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           clip_norm=1.0)


@pytest.fixture(scope="module")
def port():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    arch = dataclasses.replace(get_config("zamba2-1.2b", smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")
    cfg = {k: getattr(arch, k) for k in WIDTHS}
    return arch, cfg, build_model(arch, device="cpu")


def batch(vocab, seed=3, rows=2, seq=32):
    s = Stream(vocab, rows, seq, seed)
    return s.batch_at(0, "cpu")


def test_leaves_are_the_ports_tree(port):
    arch, cfg, model = port
    tree, _ = model.init(None)
    table = hybrid.leaves(cfg)
    assert list(table) and set(table) == set(tree)
    for k, (shape, _, _) in table.items():
        assert tuple(tree[k].shape) == shape, k


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_loss_and_gradients(port, seed):
    from repro_torch.train.loop import loss_and_grads
    arch, cfg, model = port
    params = lm_reference.draw_params(hybrid.leaves(cfg), seed, "cpu",
                                      torch.float32)
    b = batch(arch.vocab, seed)
    loss, _, grads = loss_and_grads(model, params, b)
    p32 = {k: v.clone().requires_grad_() for k, v in params.items()}
    ref = 0.0
    for i in range(2):
        part = hybrid.loss(p32, b["tokens"][i:i + 1], b["labels"][i:i + 1],
                           cfg) / 2
        part.backward()
        ref += float(part.detach())
    assert abs(float(loss) - ref) <= 2e-6 * ref
    for k, g in grads.items():
        want = p32[k].grad
        assert torch.linalg.vector_norm(g - want) <= 2e-5 * max(
            float(torch.linalg.vector_norm(want)), 1e-6), k


def test_adamw_step(port):
    """Three steps of the port's in-place AdamW and of the reference's on
    the same gradients: the same parameters and moments."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import adamw_update_
    arch, cfg, _ = port
    gen = torch.Generator().manual_seed(4)
    params = lm_reference.draw_params(hybrid.leaves(cfg), 4, "cpu",
                                      torch.bfloat16)
    mine = {k: v.clone() for k, v in params.items()}
    state = {"params": params, **adamw_init(params)}
    m = {k: torch.zeros(v.shape) for k, v in params.items()}
    v = {k: torch.zeros(t.shape) for k, t in m.items()}
    for step in range(1, 4):
        grads = {k: torch.randn(t.shape, generator=gen) * 0.3
                 for k, t in params.items()}
        adamw_update_(AdamWConfig(**OPT), state["params"], grads, state)
        lm_reference.adamw_step(mine, grads, m, v, step, OPT)
    for k in params:
        assert torch.equal(state["params"][k], mine[k]) or float(
            torch.max(torch.abs(state["params"][k].float()
                                - mine[k].float()))) <= 2 ** -7 * float(
            torch.max(torch.abs(mine[k].float()))), k
        assert torch.allclose(state["m"][k], m[k], rtol=1e-5, atol=1e-9)
        assert torch.allclose(state["v"][k], v[k], rtol=1e-5, atol=1e-12)


def test_probe_answers(port):
    """The port's probe on a table against the plain decentralized kPCA
    of the same pooled activations, at the best sign choice."""
    from repro_torch.train import activation_probe
    arch, cfg, _ = port
    table = lm_reference.draw_params(hybrid.leaves(cfg), 8, "cpu",
                                     torch.bfloat16)["embed"]
    tokens = batch(arch.vocab, seed=8, rows=24, seq=32)
    got = activation_probe({"embed": table}, tokens, hops=1, n_iters=8,
                           samples_per_node=32)
    settings = dict(hops=1, n_iters=8, samples_per_node=32, rho1=100.0,
                    rho2=dict(boundaries=[0, 10, 20],
                              values=[10.0, 50.0, 100.0]))
    gap = lm_checks.probe_number(got, table, tokens["tokens"], settings)
    assert gap < 1e-4
    # the control's kPCA (TF32 products) lands far from it
    j, n = lm_checks.probe_nodes(24, 32)
    x = lm_checks.pooled(table, tokens["tokens"])[: j * n].reshape(j, n, -1)
    mean, cv = lm_checks.probe_answers(x.float(), settings,
                                       reference.TF32)[0]
    bad = lm_checks.probe_number(dict(skipped=False, participation_mean=mean,
                                      participation_cv=cv), table,
                                 tokens["tokens"], settings)
    assert bad > 10 * gap


def test_pooled_is_the_mean_of_the_rows():
    table = torch.randn(50, 6, dtype=torch.float64)
    tokens = torch.tensor([[1, 2, 2, 49], [0, 0, 0, 3]])
    want = table[tokens].mean(dim=1)
    assert torch.allclose(lm_checks.pooled(table, tokens), want)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 9])
def test_stream_is_the_ports(seed):
    from repro_torch.data import TokenStream
    ours = Stream(500, 3, 40, seed)
    theirs = TokenStream(vocab=500, batch=3, seq=40, seed=seed, device="cpu")
    for step in range(3):
        want = theirs.next_numpy()
        got = ours.numpy(step)
        for k in ("tokens", "labels"):
            assert (got[k] == want[k]).all()


def test_ssd_against_the_recurrence():
    """The chunked scan against the recurrence written out step by step."""
    gen = torch.Generator().manual_seed(0)
    b, length, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(b, length, h, p, generator=gen, dtype=torch.float64)
    dt = torch.rand(b, length, h, generator=gen, dtype=torch.float64)
    a = -torch.rand(h, generator=gen, dtype=torch.float64)
    bb = torch.randn(b, length, n, generator=gen, dtype=torch.float64)
    cc = torch.randn(b, length, n, generator=gen, dtype=torch.float64)
    got = hybrid.ssd(x * dt[..., None], dt * a, bb, cc, chunk=8)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(length):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] \
            + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                           bb[:, t])
        want.append(torch.einsum("bhpn,bn->bhp", state, cc[:, t]))
    assert torch.allclose(got, torch.stack(want, dim=1), atol=1e-10)
