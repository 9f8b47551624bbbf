"""Back-to-back LM training steps on one device, with the DKPCA activation
probe as the loop's own hook.

The program is the port's normal training path: the configuration's
``arch`` from the port's registry (``configs.get_config``) with the file's
``overrides`` (a cut of depth or of the experts held), ``models.
build_model``, ``train.loop.build_train_step`` with the ``AdamWConfig``
the file states, and ``train.activation_probe``. The benchmark draws the
weights from the seed (``lm_reference.draw_params``, the leaves checked
against the port's own tree) and hands them to the step's state, whose
moments are the port's ``optim.adamw_init``; the batches are the
benchmark's frozen copy of the port's token stream (``kpcabench.tokens``),
one batch a step, no batch used twice; the probe batch is drawn at
set-up from the same stream at a step no training batch uses.

Set-up runs the first ``warm_steps`` steps through the window's own call
and feed (the probe after the first, as the loop's hook runs it after
every step whose index divides by ``probe_every``): every shape is then
warm. The window runs steps back to back from there, each ending when its
loss reaches the host (as ``train()`` ends one), the probe after each step
the period names; a run stops after the step that reaches ``--seconds``.
A traced run profiles ``trace_steps`` steps instead, in the spans
``train.step`` and ``probe``. The reference follows set-up's steps and the
window's first.

The traffic mix's keys: ``batch``, ``seq`` (a step's sequences and their
length), ``probe_every``, ``probe_batch`` (sequences pooled by the probe),
``probe`` (its settings: ``hops``, ``n_iters``, ``samples_per_node``, and
the ``rho1`` and ``rho2`` it runs at), ``warm_steps``. The cell's:
``trace_steps``, ``limits``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from .. import lm_checks, lm_reference, reference
from ..tokens import Stream
from ..raw_trace import profiled
from . import Outcome
from .fit import no_phase, sync_of, synced

# the stream step of the probe batch: no training batch uses it
PROBE_STEP = 1 << 40


def program(cfg: dict, traffic: dict, device):
    """(step_fn, probe_fn, the port's tree on the meta device): the
    training step and the probe on ``device``, for the registry's
    ``arch`` (its smoke preset where the file says ``smoke``) with the
    file's ``overrides``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import activation_probe, build_train_step
    arch = dataclasses.replace(
        get_config(cfg["arch"], smoke=bool(cfg.get("smoke"))),
        **cfg.get("overrides", {}))
    model = build_model(arch, device=device)
    _, step_fn = build_train_step(model, AdamWConfig(**cfg["adamw"]))
    ps = traffic["probe"]

    def probe_fn(state, batch):
        return activation_probe(state["params"], batch, hops=ps["hops"],
                                n_iters=ps["n_iters"],
                                samples_per_node=ps["samples_per_node"])
    tree, _ = model.init(None)
    return step_fn, probe_fn, tree


def start_state(cfg: dict, table: dict, tree: dict, seed: int, device):
    """The step's state from the benchmark's weights: the port's AdamW
    moments and step counter beside them. The weights' leaves are the
    port's tree's, leaf for leaf, in shape and dtype."""
    from repro_torch.optim import adamw_init
    params = lm_reference.draw_params(table, seed, device,
                                      getattr(torch, cfg["param_dtype"]))
    want = {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}
    have = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    if want != have:
        differ = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise SystemExit(f"kpcabench: the reference's leaves differ from "
                         f"the port's tree: {differ}")
    return {"params": params, **adamw_init(params)}


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    cfg, traffic, spec = cell.config, cell.traffic, cell.spec
    sync = sync_of(device)
    t_start = time.perf_counter()
    step_fn, probe_fn, tree = program(cfg, traffic, device)
    table = lm_reference.family(cfg["family"]).leaves(cfg)
    state = start_state(cfg, table, tree, seed, device)
    stream = Stream(cfg["vocab"], traffic["batch"], traffic["seq"], seed)
    probe_batch = Stream(cfg["vocab"], traffic["probe_batch"],
                         traffic["seq"], seed).batch_at(PROBE_STEP, device)
    sync()
    t_inputs = time.perf_counter()
    probes = []       # (answers, the embedding table the probe read)
    got = dict(losses=[])     # of the steps the reference follows

    def one_step(i, phase):
        """Step ``i`` on its batch, the probe after it where the period
        says; returns whether the NaN guard skipped it, and keeps the
        step's loss where the reference follows it."""
        batch = stream.batch_at(i, device)
        with phase("train.step"):
            _, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        if i <= traffic["warm_steps"]:
            got["losses"].append(loss)
        if i == 0:
            got["grad_norm"] = float(metrics["grad_norm"])
        if i % traffic["probe_every"] == 0:
            with phase("probe"):
                answers = probe_fn(state, probe_batch)
            probes.append((answers, state["params"]["embed"].clone()))
        return bool(metrics["skipped"])

    # set-up: the first steps
    for i in range(traffic["warm_steps"]):
        one_step(i, no_phase)
        if i == 0:
            b1 = cfg["adamw"]["b1"]
            got["grad"] = {k: n / (1.0 - b1) for k, n in
                           lm_checks.leaf_norms(state["m"]).items()}
    start = lm_reference.draw_params(table, seed, device,
                                     getattr(torch, cfg["param_dtype"]))
    got["change"] = lm_checks.change_norms(state["params"], start)
    del start
    sync()
    setup_end = time.perf_counter()
    stages = dict(program_and_inputs_s=t_inputs - t_start,
                  warm_steps_s=setup_end - t_inputs)
    first = traffic["warm_steps"]
    digest, failed = None, 0
    if trace:
        phase = synced(sync)

        def window():
            return [one_step(i, phase)
                    for i in range(first, first + spec["trace_steps"])]
        skipped, digest = profiled(window, sync)
        steps, elapsed = spec["trace_steps"], digest["window_s"]
        failed = sum(skipped)
    else:
        steps = 0
        t0 = time.perf_counter()
        while True:
            failed += one_step(first + steps, no_phase)
            steps += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    del state, step_fn, probe_fn
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    batches = [stream.batch_at(i, device) for i in range(first + 1)]
    ref = lm_checks.reference_steps(cfg, table, seed, batches, device,
                                    change_at=first)
    found = lm_checks.train_numbers(got, ref)
    settings = traffic["probe"]
    found["probe"] = lm_checks.probes_number(probes, probe_batch["tokens"],
                                             settings, reference.EXACT)
    tokens = traffic["batch"] * traffic["seq"]
    return Outcome(
        setup_end=setup_end,
        end_to_end=dict(train_tokens_per_s=steps * tokens / elapsed),
        attempted=steps, failed=failed, checks=found,
        memory_peak_bytes=peak,
        counters=dict(steps=steps, tokens_per_step=tokens,
                      probes=len(probes),
                      checked=lm_checks.train_detail(got, ref),
                      setup_stages=stages),
        digest=digest,
        busy_s=digest["busy_s"] if digest else None,
        window_s=digest["window_s"] if digest else None)


def control(cell, seed: int, count: int, device, fault: str = "") -> dict:
    """The control's numbers: the reference in the program's place with
    fp8 training's products (``lm_reference.FP8``) and the probe's kPCA in
    TF32 (``reference.TF32``), judged against the reference by the cell's
    own numbers, from the cell's own weights, batches and probe batch
    (``count`` is not used: the cell compares the steps the reference
    follows, set-up's and the window's first). A fault instead, planted
    in the reference put in the program's place in its own precision:
    ``half_batch``, each step's loss and gradients taken over the first
    half of the batch's sequences; ``unchanged``, a step that returns its
    state unchanged."""
    cfg, traffic = cell.config, cell.traffic
    table = lm_reference.family(cfg["family"]).leaves(cfg)
    stream = Stream(cfg["vocab"], traffic["batch"], traffic["seq"], seed)
    first = traffic["warm_steps"]
    batches = [stream.batch_at(i, device) for i in range(first + 1)]
    if fault == "half_batch":
        half = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        ctl = lm_checks.reference_steps(cfg, table, seed, half, device,
                                        change_at=first)
    elif fault == "unchanged":
        ctl = lm_checks.reference_steps(cfg, table, seed, batches, device,
                                        frozen=True, change_at=first)
    elif fault:
        raise SystemExit(f"kpcabench: no fault {fault!r}")
    else:
        ctl = lm_checks.reference_steps(cfg, table, seed, batches, device,
                                        lm_reference.FP8, change_at=first)
    ref = lm_checks.reference_steps(cfg, table, seed, batches, device,
                                    change_at=first)
    found = lm_checks.train_numbers(ctl, ref)
    print(json.dumps(dict(seed=seed, fault=fault,
                          detail=lm_checks.train_detail(ctl, ref))),
          file=sys.stderr)
    if fault:
        return found
    probe_batch = Stream(cfg["vocab"], traffic["probe_batch"],
                         traffic["seq"], seed).batch_at(PROBE_STEP, device)
    embed = lm_reference.draw_params({"embed": table["embed"]}, seed,
                                     device)["embed"]
    settings = traffic["probe"]
    tokens = probe_batch["tokens"]
    j, n = lm_checks.probe_nodes(tokens.shape[0],
                                 settings["samples_per_node"])
    x = lm_checks.pooled(embed, tokens)[: j * n].reshape(j, n, -1)
    mean, cv = lm_checks.probe_answers(x.float(), settings,
                                       reference.TF32)[0]
    answers = dict(skipped=False, participation_mean=mean,
                   participation_cv=cv)
    found["probe"] = lm_checks.probe_number(answers, embed, tokens,
                                            settings)
    return found


__all__ = ["PROBE_STEP", "control", "program", "run", "start_state"]
