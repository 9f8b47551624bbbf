"""The numbers that decide ``correct`` in a training cell, the program's
readings against the plain reference's (``lm_reference``) from the same
weights and batches the benchmark drew:

  * ``loss``: over the steps set-up ran (``warm_steps``) and the window's
    first step, the worst |l - l_ref| / |l_ref|;
  * ``grad``: the first gradient as the optimizer takes it (clipped),
    the program's worked out from its first moment after one step
    (m / (1 - b1)); over leaves, the worst gap between the two norms,
    |n - n_ref|, over the larger of the reference leaf's norm and the
    median leaf's;
  * ``grad_norm``: the first step's relative gap of the whole gradient's
    norm before clipping, as the step reports it (the clipped gradient's
    norms cannot see a gradient taken over part of the batch, whose norm
    before clipping is larger; later steps' norms fall tenfold as the
    trajectories part, and are not compared);
  * ``update``: the parameters' change after set-up's steps, the same gap
    of norms by leaf; a leaf whose reference gradient is under a
    thousandth of the median leaf's is left out (Adam moves it by
    round-off alone);
  * ``probe``: every probe of the run, its answers (the nodes' mean
    participation and its coefficient of variation) against those of the
    plain decentralized kPCA (``reference.fit``, float64) of the same
    pooled activations at the probe's settings, from the local warm start
    under the sign of each node's eigenvector that matches best (the
    eigensolver picks the signs); the worst over the probes of
    ``answer_gap``.

The reference follows the program's trajectory only through the probe's
input: each probe is judged on the embedding table the program held when
it ran (the table's own path is what ``update`` judges)."""

from __future__ import annotations

import itertools
import math
import statistics

import torch

from . import lm_reference, reference

# leaves whose reference gradient is below this share of the median leaf's
# are left out of ``update``
NOUGHT = 1e-3


def leaf_norms(tree: dict) -> dict:
    """{leaf: its float64 norm}."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def change_norms(now: dict, start: dict) -> dict:
    """{leaf: ||now - start||} in float64."""
    return {k: float(torch.linalg.vector_norm(now[k].double()
                                              - start[k].double()))
            for k in now}


def leaf_gaps(got: dict, ref: dict, keys=None) -> dict:
    """{leaf: |got - ref| over max(ref, the median of ref)}."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def gap_of_norms(got: dict, ref: dict, keys=None) -> float:
    """The worst of ``leaf_gaps``."""
    return max(leaf_gaps(got, ref, keys).values())


def reference_steps(cfg: dict, table: dict, seed: int, batches: list,
                    device, prec=lm_reference.FP32, frozen: bool = False,
                    change_at=None) -> dict:
    """The reference's first ``len(batches)`` steps from the benchmark's
    weights: each step's loss (micro-batches of one sequence, the
    gradients summed), the first gradient's norm before clipping and its
    clipped leaf norms, and the change's leaf norms after step
    ``change_at`` (the last by default); parameters stored in the
    configuration's dtype, computed in float32. ``frozen``: a step that
    returns its state unchanged (the fault), whose moments, and so the
    gradient read from them, stay zero."""
    lm_reference.no_tf32()
    fam = lm_reference.family(cfg["family"])
    dtype = getattr(torch, cfg["param_dtype"])
    change_at = len(batches) if change_at is None else change_at
    start = lm_reference.draw_params(table, seed, device, dtype)
    params = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=device)
         for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    out = dict(losses=[])
    for step, batch in enumerate(batches, start=1):
        p32 = {k: t.float().requires_grad_() for k, t in params.items()}
        rows = batch["tokens"].shape[0]
        total = 0.0
        for i in range(rows):
            part = fam.loss(p32, batch["tokens"][i:i + 1],
                            batch["labels"][i:i + 1], cfg, prec) / rows
            part.backward()
            total += float(part.detach())
        out["losses"].append(total)
        grads = {k: t.grad for k, t in p32.items()}
        del p32
        if step == 1:
            out["grad_norm"] = math.sqrt(sum(
                float(torch.sum(g.double() ** 2)) for g in grads.values()))
        if frozen:
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        opt = dict(cfg["adamw"], lr=0.0) if frozen else cfg["adamw"]
        scale = lm_reference.adamw_step(params, grads, m, v, step,
                                        opt)["scale"]
        if step == 1:
            out["grad"] = {k: n * scale
                           for k, n in leaf_norms(grads).items()}
        del grads
        if step == change_at:
            out["change"] = change_norms(params, start)
    return out


def loss_gaps(got: dict, ref: dict) -> list:
    """Each step's |l - l_ref| / |l_ref|; the two sides' steps must pair."""
    if len(got["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(got['losses'])} losses against "
                         f"{len(ref['losses'])}")
    return [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                ref["losses"])]


def train_numbers(got: dict, ref: dict) -> dict:
    """``loss``, ``grad``, ``grad_norm`` and ``update`` of the program's
    readings (``losses``, ``grad``, ``grad_norm``, ``change`` as
    ``reference_steps`` gives them) against the reference's."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k, n in ref["grad"].items() if n >= NOUGHT * med]
    return dict(loss=max(loss_gaps(got, ref)),
                grad=gap_of_norms(got["grad"], ref["grad"]),
                grad_norm=abs(got["grad_norm"] - ref["grad_norm"])
                / ref["grad_norm"],
                update=gap_of_norms(got["change"], ref["change"], moved))


def train_detail(got: dict, ref: dict) -> dict:
    """Where the numbers come from: each step's loss gap, the leaves left
    out of ``update``, and the three worst leaves of ``grad`` and of
    ``update``."""
    def worst(gaps):
        return sorted(([k, v] for k, v in gaps.items()),
                      key=lambda kv: -kv[1])[:3]
    med = statistics.median(ref["grad"].values())
    return dict(loss_gaps=loss_gaps(got, ref),
                left_out=[k for k, n in ref["grad"].items()
                          if n < NOUGHT * med],
                ref_losses=ref["losses"],
                grad=worst(leaf_gaps(got["grad"], ref["grad"])),
                update=worst(leaf_gaps(got["change"], ref["change"])))


def pooled(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, E) float64 mean of each row's token embeddings: its token
    counts against the table."""
    b, seq = tokens.shape
    counts = torch.zeros((b, table.shape[0]), dtype=torch.float64,
                         device=table.device)
    counts.scatter_add_(1, tokens.long().to(table.device),
                        torch.ones(tokens.shape, dtype=torch.float64,
                                   device=table.device))
    return counts @ table.double() / seq


def probe_nodes(b: int, samples_per_node: int) -> tuple:
    """(J, N) of a probe of ``b`` pooled rows on one device."""
    j = max(b // samples_per_node, 3)
    return j, min(samples_per_node, b // j)


def probe_answers(x_nodes, settings: dict, prec=reference.EXACT) -> list:
    """The answers (mean participation, its coefficient of variation) of
    the plain decentralized kPCA of ``x_nodes`` (J, N, E), one for each
    choice of the nodes' eigenvector signs (the first node's fixed)."""
    j, n, _ = x_nodes.shape
    x = x_nodes.to(prec.dtype)
    pooled_rows = x.reshape(j * n, -1)
    gamma = reference.median_gamma(pooled_rows, prec)
    k = reference.rbf(pooled_rows, pooled_rows, gamma, prec)
    mrow = torch.mean(k, dim=1)
    kc = k - mrow[:, None] - mrow[None, :] + torch.mean(mrow)
    blocks = torch.stack([kc[i * n:(i + 1) * n, i * n:(i + 1) * n]
                          for i in range(j)])
    lam, vec = torch.linalg.eigh(blocks.double())
    local = (vec[:, :, -1] / torch.sqrt(torch.clamp(lam[:, -1:], min=1e-12))
             ).to(prec.dtype)
    hops = min(settings["hops"], (j - 1) // 2) or 1
    cfg = dict(hops=hops, rho1=settings["rho1"], rho2=settings["rho2"],
               iterations=settings["n_iters"])
    out = []
    for signs in itertools.product((1.0, -1.0), repeat=j - 1):
        s = torch.tensor((1.0,) + signs, dtype=prec.dtype,
                         device=x.device)
        alpha = reference.fit(x_nodes, s[:, None] * local, cfg, prec).alpha
        energy = torch.linalg.vector_norm(alpha.double(), dim=1)
        mean = torch.mean(energy)
        out.append((float(mean), float(torch.std(energy, unbiased=False)
                                       / torch.clamp(mean, min=1e-9))))
    return out


def answer_gap(got: tuple, ref: tuple) -> float:
    """The larger of the mean participation's relative gap and the
    coefficient of variation's gap (a ratio already: its relative gap
    would divide the nodes' energies' error by their small spread)."""
    return max(abs(got[0] - ref[0]) / max(abs(ref[0]), 1e-30),
               abs(got[1] - ref[1]))


def probe_number(answers: dict, table, tokens, settings: dict,
                 prec=reference.EXACT):
    """One probe's gap: the best over sign choices of ``answer_gap``;
    None for a probe that gave no answer."""
    if not answers or answers.get("skipped", True):
        return None
    j, n = probe_nodes(tokens.shape[0], settings["samples_per_node"])
    x = pooled(table, tokens)[: j * n].reshape(j, n, -1)
    got = (answers["participation_mean"], answers["participation_cv"])
    return min(answer_gap(got, ref)
               for ref in probe_answers(x, settings, prec))


def probes_number(probes: list, tokens, settings: dict,
                  prec=reference.EXACT):
    """The worst ``probe_number`` over the run's probes [(answers,
    table)]; None where there was none, or one gave no answer."""
    vals = [probe_number(a, t, tokens, settings, prec) for a, t in probes]
    if not vals or any(v is None for v in vals):
        return None
    return max(vals)


__all__ = ["NOUGHT", "answer_gap", "change_norms", "gap_of_norms", "leaf_gaps",
           "leaf_norms", "loss_gaps", "train_detail",
           "pooled", "probe_answers", "probe_nodes", "probe_number",
           "probes_number", "reference_steps", "train_numbers"]
