"""The port's prefill and decode over a ``torch.distributed`` device mesh
(context-parallel KV cache, every family), on the CPU over gloo, against
the port's own one-device decode and the JAX package's mesh decode, on
the same seeded numpy weights and prompts (fp32 smoke configs, fp32
caches).

The port's ranks are ``python -c`` children (they import this module for
``rank_main``, which loads no JAX) in a world of 4 over the meshes (4, 1),
(2, 2) and (1, 4), and a world of 1 for the (1, 1) mesh and the
one-device run, meeting at ``file://`` stores under the test's temporary
directory, each waited on with a timeout. Every run is a prefill of the
prompt into a cache of MAX_LEN slots and 8 greedy decode steps. Cases:
a llama-style dense config, the same with a sliding window whose ring the
prompt fills and the steps wrap (the S >= window prefill), deepseek-v2's
(MLA's latent cache, a dense first layer, shared and routed experts,
drop-free at these token counts), mixtral's (a sliding window of 32 slots
and experts), falcon-mamba's (column-parallel mamba1; with a d_inner of
126, which 4 does not divide, the layer gathered whole at (1, 4)),
zamba2's (mamba2 split over "model" by heads, one head a rank at (1, 4):
its states gathered whole once a step, each layer on its heads' ssm
state, the new states all-gathered over the heads at the end of the
step; the shared block's cache context-parallel) and seamless's (enc_out
laid out by the dry-run's heuristic, gathered once a step).

  * (1, 1): the prefill's logits and every step's, bitwise the no-mesh
    run's (and the greedy tokens equal);
  * (4, 1), (2, 2), (1, 4): within 2e-5 * max(1, |ref|) of the one-device
    run, with equal greedy tokens (the merge reorders sums);
  * (2, 2) against the JAX package's ``build_model(cfg, mesh=)`` decode on
    the 4 host devices of ``tests/conftest.py`` (run in the test process
    while the port's ranks run), its cache placed by the reference's own
    ``_cache_sharded``: equal greedy tokens, and within 1e-4 * max(1,
    |ref|), the JAX loop's parity tolerance;
  * the rank's cache shards gathered, against the one-device cache at
    2e-5 (and their shapes the shard shapes of ``cache_specs``);
  * at (2, 2) and (1, 4) no all-gather over "model" of a whole mamba leaf
    (falcon-mamba, zamba2), but where d_inner 126 falls back to the whole
    layer at (1, 4).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 300
MAX_LEN = 48            # cache slots: the caches' longest dim, over 4 ranks
STEPS = 8
B = 4
MESHES = ((4, 1), (2, 2), (1, 4))
# case: (config, overrides, prompt length)
CASES = {
    "dense": ("llama3.2-3b", {}, 4),
    "swa": ("llama3.2-3b", dict(attn_kind="swa", window=24), 24),
    "mla_moe": ("deepseek-v2-236b", {}, 4),
    "swa_moe": ("mixtral-8x22b", dict(window=32), 4),
    "falcon": ("falcon-mamba-7b", {}, 4),
    # d_inner 126: split over a model axis of 2, not of 4 (each layer and
    # its states gathered whole there)
    "falcon_odd": ("falcon-mamba-7b", dict(d_inner=126), 4),
    "zamba2": ("zamba2-1.2b", {}, 4),
    "seamless": ("seamless-m4t-large-v2", {}, 4),
}
TOL_MESH = 2e-5
TOL_JAX = 1e-4


def case_cfg(case):
    name, over, _ = CASES[case]
    return dataclasses.replace(tcfgs.get_config(name, smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32", **over)


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def make_problems(root: Path) -> None:
    """Every case's weights (the port's seeded draws) and prompt."""
    from repro_torch.models import build_model
    for i, case in enumerate(CASES):
        cfg = case_cfg(case)
        w, _ = build_model(cfg, device="cpu").init(40 + i)
        rng = np.random.default_rng(i)
        arrays = {f"p:{k}": np_of(v) for k, v in w.items()}
        arrays["tokens"] = rng.integers(0, cfg.vocab,
                                        size=(B, CASES[case][2]),
                                        dtype=np.int32)
        if cfg.family == "audio":
            arrays["frames"] = rng.normal(0, 0.02, size=(
                B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        np.savez(root / f"{case}.npz", **arrays)


def load_problem(root: Path, case):
    with np.load(root / f"{case}.npz") as z:
        params = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
        batch = {k: z[k] for k in z.files if not k.startswith("p:")}
    return params, batch


# ---------------------------------------------------------------------------
# the port's ranks


def _mesh(shape, store: str, rank: int, world: int):
    from repro_torch.launch import make_mesh
    return make_mesh(shape, ("data", "model"), device="cpu", rank=rank,
                     world_size=world, local_rank=0,
                     init_method=f"file://{store}")


def greedy(model, params, batch, feed=None):
    """Prefill and STEPS greedy steps (or the tokens of ``feed``): (the
    logits of the prefill and each step (STEPS + 1, B, V), the tokens fed
    (STEPS, B), the last cache)."""
    s = batch["tokens"].shape[1]
    logits, cache = model.prefill(params, batch, MAX_LEN,
                                  dtype=torch.float32)
    outs, fed = [logits], []
    for i in range(STEPS):
        tok = (torch.argmax(logits, dim=-1) if feed is None
               else torch.as_tensor(feed[i]))
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None].to(
            torch.int32), s + i)
        outs.append(logits)
    return torch.stack(outs), torch.stack(fed), cache


def run_case(case, root: Path, mesh):
    """One case on ``mesh`` (None: one device): (logits, tokens, the cache
    gathered whole, the shard shapes against cache_specs', the collectives,
    the all-gathers over "model" of a whole mamba leaf)."""
    from repro_torch.distributed import local_shard, shard_shape
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.models import build_model
    cfg = case_cfg(case)
    full, batch = load_problem(root, case)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = build_model(cfg, mesh=mesh, device="cpu")
    params = {k: torch.as_tensor(v) for k, v in full.items()}
    if mesh is not None:
        sh = model.shards()
        params = {k: local_shard(v, sh.specs[k], mesh).clone()
                  for k, v in params.items()}
    from test_torch_dist_train import WholeGathers, mamba_leaves
    leaves = [] if mesh is None else mamba_leaves(full, model.shards())
    with WholeGathers(leaves) as spy:
        logits, toks, cache = greedy(model, params, batch)
    shapes_ok = True
    if mesh is not None:
        whole = [gather_full(t, sp, mesh) for t, sp in
                 zip(cache.shards, cache.specs)]
        shapes_ok = all(tuple(t.shape) == shard_shape(w.shape, sp, mesh)
                        for t, w, sp in zip(cache.shards, whole,
                                            cache.specs))
        cache = whole
    return logits, toks, list(cache), shapes_ok, dict(
        mesh.counts) if mesh is not None else {}, spy.hits


def rank_main(world: int, rank: int, store: str, root: str) -> None:
    import torch.distributed as dist
    root = Path(root)
    out = root / f"world{world}"
    res = {}
    try:
        torch.manual_seed(0)
        runs = ([(shape, _mesh(shape, store, rank, world))
                 for shape in MESHES] if world == 4 else
                [("none", None), ((1, 1), _mesh((1, 1), store, 0, 1))])
        for shape, mesh in runs:
            tag = shape if shape == "none" else f"{shape[0]}x{shape[1]}"
            for case in CASES:
                if mesh is not None:
                    mesh.counts.clear()
                logits, toks, cache, ok, counts, hits = run_case(case, root,
                                                                 mesh)
                res[f"{case}@{tag}"] = dict(shapes_ok=ok, counts=counts,
                                            whole_leaf_gathers=hits)
                if rank == 0:
                    np.savez(out / f"{case}@{tag}.npz", logits=np_of(logits),
                             tokens=toks.numpy(),
                             **{f"c{i}": np_of(c) for i, c in
                                enumerate(cache)})
        if rank == 0:
            (out / "res.json").write_text(json.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's mesh decode at (2, 2)


def jax_reference(root: Path, case):
    """The JAX package's prefill and STEPS greedy steps over a (2, 2) mesh
    of the 4 host devices: (logits (STEPS + 1, B, V), tokens (STEPS,
    B))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.launch import dryrun as jdry
    assert jax.device_count() == 4, jax.devices()
    from repro.configs import get_config as jget
    from repro.distributed.sharding import default_rules, spec_for
    from repro.models import build_model as jbuild
    from repro.models import encdec as jencdec, hybrid as jhybrid
    from repro.models.common import abstract_params
    name, over, s = CASES[case]
    cfg = dataclasses.replace(jget(name, smoke=True), param_dtype="float32",
                              compute_dtype="float32", **over)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    rules = default_rules(False)
    model = jbuild(cfg, mesh=mesh)
    _, axes = abstract_params(lambda k: model.init(k),
                              jax.random.PRNGKey(0))
    full, batch = load_problem(root, case)
    params = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, spec_for(v.shape, axes[k], rules, mesh)))
        for k, v in full.items()}
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P("data", *([None] * (v.ndim - 1))))) for k, v in batch.items()}
    f32 = jnp.float32

    def place(cache):
        sds = jdry._cache_sharded(jax.eval_shape(lambda: cache), cfg, rules,
                                  mesh)
        return jax.tree.map(lambda c, d: jax.device_put(c, d.sharding),
                            cache, sds)

    if cfg.family in ("dense", "moe", "vlm"):
        cache = place(model.init_cache(B, MAX_LEN, dtype=f32))
        logits, cache = jax.jit(model.decode_step)(
            params, cache, batch["tokens"], jnp.zeros((), jnp.int32))
    elif cfg.family == "hybrid":
        logits, cache = jax.jit(lambda p, b: jhybrid.hybrid_prefill(
            p, cfg, b, MAX_LEN, mesh=mesh, cache_dtype=f32))(params, batch)
    elif cfg.family == "audio":
        logits, cache = jax.jit(lambda p, b: jencdec.encdec_prefill(
            p, cfg, b, MAX_LEN, mesh=mesh, cache_dtype=f32))(params, batch)
    else:
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b, MAX_LEN))(
            params, batch)
    cache = place(cache)
    step = jax.jit(model.decode_step)
    outs, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        fed.append(np.argmax(outs[-1], axis=-1))
        tok = jax.device_put(jnp.asarray(fed[-1][:, None], jnp.int32),
                             NamedSharding(mesh, P("data", None)))
        logits, cache = step(params, cache, tok,
                             jnp.asarray(s + i, jnp.int32))
        outs.append(np.asarray(logits))
    return np.stack(outs), np.stack(fed)


# ---------------------------------------------------------------------------
# launching


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               OMP_NUM_THREADS="1")
    return env


def _spawn_world(world: int, root: Path):
    (root / f"world{world}").mkdir()
    code = ("import sys; from test_torch_dist_decode import rank_main; "
            "rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "sys.argv[4])")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(world), str(r),
         str(root / f"store{world}"), str(root)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds, and meanwhile the JAX package's references:
    (root, {case: (logits, tokens)})."""
    root = tmp_path_factory.mktemp("decode")
    make_problems(root)
    procs = {w: _spawn_world(w, root) for w in (4, 1)}
    try:
        jax_refs = {case: jax_reference(root, case) for case in CASES}
        for w, ps in procs.items():
            for r, p in enumerate(ps):
                log, _ = p.communicate(timeout=RANK_TIMEOUT_S)
                assert p.returncode == 0, f"world {w} rank {r}:\n{log}"
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return root, jax_refs


def _got(root: Path, case, tag):
    world = 4 if tag in ("4x1", "2x2", "1x4") else 1
    with np.load(root / f"world{world}" / f"{case}@{tag}.npz") as z:
        return {k: z[k] for k in z.files}


def _res(root: Path, world) -> dict:
    return json.loads((root / f"world{world}" / "res.json").read_text())


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_a_one_rank_mesh_is_the_no_mesh_decode(runs, case):
    runs, _ = runs
    got, want = _got(runs, case, "1x1"), _got(runs, case, "none")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (case, k)
    assert _res(runs, 1)[f"{case}@1x1"]["counts"] == {}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_decode_matches_one_device(runs, case, shape):
    runs, _ = runs
    tag = f"{shape[0]}x{shape[1]}"
    got, want = _got(runs, case, tag), _got(runs, case, "none")
    assert np.array_equal(got["tokens"], want["tokens"]), (case, tag)
    for i in range(STEPS + 1):
        _close(got["logits"][i], want["logits"][i], TOL_MESH,
               f"{case} {tag} step {i}")
    for k in want:
        if k.startswith("c"):
            _close(got[k], want[k], TOL_MESH, f"{case} {tag} cache {k}")
    res = _res(runs, 4)[f"{case}@{tag}"]
    assert res["shapes_ok"], (case, tag)
    assert res["counts"], (case, tag)


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ("falcon", "falcon_odd", "zamba2"))
def test_mamba_leaves_gathered_whole_only_in_the_fallback(runs, case, shape):
    """Prefill and decode run the mamba layers split over "model": no
    all-gather over "model" returns a whole mamba leaf, but in the
    divisibility fallback (d_inner 126 over 4)."""
    runs, _ = runs
    hits = _res(runs, 4)[f"{case}@{shape[0]}x{shape[1]}"][
        "whole_leaf_gathers"]
    assert (hits > 0) == (case == "falcon_odd" and shape == (1, 4)), hits


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_decode_matches_jax_at_2x2(runs, case):
    root, jax_refs = runs
    got = _got(root, case, "2x2")
    want, want_tokens = jax_refs[case]
    assert np.array_equal(got["tokens"], want_tokens), case
    for i in range(STEPS + 1):
        _close(got["logits"][i], want[i], TOL_JAX, f"{case} step {i}")
