"""The rule a bf16 training step over a device mesh is held to, anchored
in the JAX package's own sharded step, on the CPU.

For one step-1 gradient on the same weights and batch: ``g32`` is one
device's gradient with the weights widened to fp32, ``g1`` one device's
bf16 gradient, ``gm`` the mesh's bf16 gradient gathered whole (a leaf
replicated over the mesh counted once). Per leaf, and for the whole
flattened gradient, ``d1 = |g1 - g32|``, ``dm = |gm - g32|`` and
``r = dm / d1``. The rule, of the form the families' bf16 decode is held
to (1.25 x one device's distance from fp32):

    dm <= 1.25 d1 + 1e-3 |g32|

The JAX package's side runs in subprocesses with 4 host devices: zamba2's
step-1 ``jax.value_and_grad`` on the port's seeded bf16 weights, single
device in bf16 and in fp32 and under GSPMD at (2, 2) and (1, 4) in bf16,
the params placed by ``spec_for`` (as ``tests/test_torch_dist_train.py``
places its sharded references): ``r_ref`` per leaf. The port's side runs
on 4 gloo ranks (``python -c`` children that load no JAX): the same step
at (2, 2) and (1, 4), zamba2's mamba2 layers split over "model", and on
rank 0 its one-device bf16 and fp32 steps; every bf16 product of the
model modules from its inputs widened to fp32 and rounded once
(``card_gemms``: a card's bf16 GEMM accumulates in fp32, the CPU's own
bf16 products round otherwise). Asserted:

  (a) the port within ``1.25 max(1, r_ref) d1 + 1e-3 |g32|`` per leaf and
      whole, at both meshes;
  (b) a mutation, the split step with the replicated leaves' partial
      gradients not summed over "model", fails the rule;
  (c) recorded, no gate: the split path with the SSD scan's carried
      state rounded to bf16 each chunk (the fp32 check cannot see it).

The config is zamba2's smoke config (d_inner 128, 4 heads, so "model" 4
divides it) deepened to ZAMBA_LAYERS layers, where one device's bf16
``w_in`` gradient lies at least 10 % from fp32 in both packages (also
asserted), on a batch of ROWS x SEQ tokens.

Beside it (ROADMAP C5), llama3.2-3b's smoke config in bf16: the JAX
package's single-device ``build_train_step`` against its GSPMD (2, 2) and
(1, 4) steps, and the port's, LLAMA_STEPS AdamW steps from the same
weights and batches: loss and grad norm at each step and step 1's per-leaf
``r``. Recorded; no llama gate reads them. ``pytest -s`` prints every
reading as one JSON line.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.data import TokenStream
from repro_torch.models import build_model

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
TIMEOUT_S = 300
WORLD = 4
MESHES = ((2, 2), (1, 4))
TAGS = tuple("{}x{}".format(*s) for s in MESHES)
RULE_FACTOR, RULE_FLOOR = 1.25, 1e-3
ZAMBA_LAYERS = 8
ROWS, SEQ = 4, 32
LLAMA_STEPS = 3
# the port's mesh runs: the step as it trains (zamba2's mamba2 layers
# split), and the two controls
RUNS = ("mesh", "nosum", "bf16carry")


def zamba_cfg(dtype: str = "bfloat16"):
    return dataclasses.replace(tcfgs.get_config("zamba2-1.2b", smoke=True),
                               n_layers=ZAMBA_LAYERS, param_dtype=dtype,
                               compute_dtype=dtype)


def llama_cfg(dtype: str = "bfloat16"):
    return dataclasses.replace(tcfgs.get_config("llama3.2-3b", smoke=True),
                               param_dtype=dtype, compute_dtype=dtype)


CFGS = {"zamba2": zamba_cfg, "llama": llama_cfg}


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def save(path: Path, tree: dict) -> None:
    np.savez(path, **tree)


def load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def make_problems(root: Path) -> None:
    """Each config's seeded bf16 weights (as fp32 numpy, exact) and its
    batches, for both packages."""
    for i, (name, cfg_of) in enumerate(CFGS.items()):
        cfg = cfg_of()
        w, _ = build_model(cfg, device="cpu").init(30 + i)
        save(root / f"{name}_p.npz", {k: np_of(v) for k, v in w.items()})
        data = TokenStream(cfg.vocab, ROWS, SEQ, seed=i, device="cpu")
        for s in range(LLAMA_STEPS):
            save(root / f"{name}_b{s}.npz", data.next_numpy())


# ---------------------------------------------------------------------------
# the rule


def norm(a) -> float:
    return float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))


def distances(g32: dict, g1: dict, gm: dict) -> dict:
    """{leaf or "whole": (d1, dm, |g32|)}."""
    out = {k: (norm(g1[k] - v), norm(gm[k] - v), norm(v))
           for k, v in g32.items()}
    whole = lambda i: math.sqrt(sum(d[i] ** 2 for d in out.values()))
    out["whole"] = (whole(0), whole(1), whole(2))
    return out


def ratio(d1: float, dm: float) -> float:
    return dm / d1 if d1 > 0 else (1.0 if dm == 0 else math.inf)


def misses(dist: dict, r_ref=None) -> dict:
    """The leaves (and "whole") past ``dm <= 1.25 max(1, r_ref) d1 + 1e-3
    |g32|`` (``r_ref`` None: the plain rule), with (dm, the bound)."""
    out = {}
    for k, (d1, dm, n32) in dist.items():
        f = RULE_FACTOR * (1.0 if r_ref is None else max(1.0, r_ref[k]))
        bound = f * d1 + RULE_FLOOR * n32
        if not dm <= bound:
            out[k] = (dm, bound)
    return out


# ---------------------------------------------------------------------------
# the port's ranks


@contextlib.contextmanager
def card_gemms():
    """Every bf16 product of the model modules (``tok_einsum``) from its
    inputs widened to fp32, rounded once, as a card's bf16 GEMM."""
    from repro_torch.models import attention, common, lm, mamba, mlp, moe
    orig = common.tok_einsum

    def widened(eq, x, w):
        if x.dtype != torch.bfloat16:
            return orig(eq, x, w)
        return orig(eq, x.float(), w.float()).to(torch.bfloat16)
    mods = (attention, lm, mamba, mlp, moe)
    for m in mods:
        m.tok_einsum = widened
    try:
        yield
    finally:
        for m in mods:
            m.tok_einsum = orig


@contextlib.contextmanager
def bf16_carry():
    """The SSD scan's carried state rounded to bf16 after each chunk."""
    from repro_torch.models import mamba
    orig = mamba._ssd_chunked

    def rounded(xh, b_in, c_in, dt, a, chunk, h0=None):
        ck = mamba._chunk_of(chunk, xh.shape[1])
        ys, state = [], h0
        for lo in range(0, xh.shape[1], ck):
            s = slice(lo, lo + ck)
            y, state = orig(xh[:, s], b_in[:, s], c_in[:, s], dt[:, s], a,
                            ck, state)
            state = state.to(torch.bfloat16).float()
            ys.append(y)
        return torch.cat(ys, dim=1), state
    mamba._ssd_chunked = rounded
    try:
        yield
    finally:
        mamba._ssd_chunked = orig


def _tensors(tree: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _weights(root: Path, name: str, dtype=torch.bfloat16) -> dict:
    return {k: v.to(dtype) for k, v in _tensors(
        load(root / f"{name}_p.npz")).items()}


def _batch(root: Path, name: str, step: int = 0) -> dict:
    return _tensors(load(root / f"{name}_b{step}.npz"))


def mesh_grads(root: Path, name: str, mesh, run: str = "mesh") -> dict:
    """Step 1's bf16 gradient over ``mesh``, gathered whole: the step as
    it trains (``run`` "mesh"), without the sum over "model" of the partial
    leaves ("nosum"), or with the carried ssm state in bf16
    ("bf16carry")."""
    from repro_torch.distributed import local_shard
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.train.loop import loss_and_grads, sum_replicated_grads
    model = build_model(CFGS[name](), mesh=mesh, device="cpu")
    sh = model.shards()
    params = {k: local_shard(v, sh.specs[k], mesh).clone()
              for k, v in _weights(root, name).items()}
    ctx = bf16_carry() if run == "bf16carry" else contextlib.nullcontext()
    with ctx:
        _, _, grads = loss_and_grads(model, params, _batch(root, name))
    if run == "nosum":
        sh.partial = ()
    sum_replicated_grads(grads, sh)
    return {k: np_of(gather_full(v, sh.specs[k], mesh))
            for k, v in grads.items()}


def one_device_grads(root: Path, name: str) -> tuple:
    """(g1, g32): one device's step-1 gradient in bf16 and with the
    weights widened to fp32."""
    from repro_torch.train.loop import loss_and_grads
    out = []
    for dtype, cname in ((torch.bfloat16, "bfloat16"),
                         (torch.float32, "float32")):
        _, _, g = loss_and_grads(
            build_model(CFGS[name](cname), device="cpu"),
            _weights(root, name, dtype), _batch(root, name))
        out.append({k: np_of(v) for k, v in g.items()})
    return tuple(out)


def train_steps(root: Path, name: str, mesh=None) -> list:
    """LLAMA_STEPS AdamW steps in bf16 from the problem's weights:
    [(loss, grad norm)] a step."""
    from repro_torch.distributed import local_shard
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    model = build_model(CFGS[name](), mesh=mesh, device="cpu")
    params = _weights(root, name)
    if mesh is not None:
        sh = model.shards()
        params = {k: local_shard(v, sh.specs[k], mesh).clone()
                  for k, v in params.items()}
    state = dict(params=params, **adamw_init(params))
    _, step = build_train_step(model, AdamWConfig(), mesh)
    out = []
    for s in range(LLAMA_STEPS):
        _, met = step(state, _batch(root, name, s))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def rank_main(rank: int, store: str, root: str) -> None:
    """One of the WORLD gloo ranks: each mesh's runs (rank 0 writes the
    gradients), then on rank 0 the one-device references."""
    import torch.distributed as dist
    from repro_torch.launch import make_mesh
    torch.set_num_threads(1)
    root = Path(root)
    out = root / "port"
    res = {}
    try:
        with card_gemms():
            for shape, tag in zip(MESHES, TAGS):
                mesh = make_mesh(shape, ("data", "model"), device="cpu",
                                 rank=rank, world_size=WORLD, local_rank=0,
                                 init_method=f"file://{store}")
                for run in RUNS:
                    g = mesh_grads(root, "zamba2", mesh, run)
                    if rank == 0:
                        save(out / f"zamba2_{run}_{tag}.npz", g)
                g = mesh_grads(root, "llama", mesh)
                if rank == 0:
                    save(out / f"llama_mesh_{tag}.npz", g)
                res[f"llama_{tag}"] = train_steps(root, "llama", mesh)
        dist.destroy_process_group()
        if rank == 0:
            with card_gemms():
                for name in CFGS:
                    g1, g32 = one_device_grads(root, name)
                    save(out / f"{name}_g1.npz", g1)
                    save(out / f"{name}_g32.npz", g32)
                res["llama_single"] = train_steps(root, "llama")
            (out / "res.json").write_text(json.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side (a subprocess a config, 4 host devices)


def jax_main(root: str, name: str, part: str) -> None:
    """The JAX package's side of one config: ``part`` "single" (its
    one-device fp32 and bf16 gradients) or a mesh's tag (its GSPMD bf16
    gradient); for llama also LLAMA_STEPS of its ``build_train_step``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config as jget
    from repro.distributed.sharding import default_rules as jrules
    from repro.distributed.sharding import spec_for as jspec
    from repro.models import build_model as jbuild
    from repro.optim import AdamWConfig as JOpt
    from repro.optim import adamw_init as jadamw_init
    from repro.train.loop import build_train_step as jstep
    root = Path(root)
    out = root / "jax"
    base = jget({"zamba2": "zamba2-1.2b", "llama": "llama3.2-3b"}[name],
                smoke=True)
    cfg_of = lambda dt: dataclasses.replace(
        base, n_layers=CFGS[name]().n_layers, param_dtype=dt,
        compute_dtype=dt)
    w = load(root / f"{name}_p.npz")
    batches = [load(root / f"{name}_b{s}.npz") for s in range(LLAMA_STEPS)]
    mesh = None
    if part != "single":
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
            tuple(int(d) for d in part.split("x"))), ("data", "model"))

    def placed(model, tree):
        if mesh is None:
            return tree
        _, axes = model.init(jax.random.PRNGKey(0))
        return {k: jax.device_put(v, NamedSharding(
            mesh, jspec(v.shape, axes[k], jrules(False), mesh)))
            for k, v in tree.items()}

    def batch_of(b):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if mesh is None:
            return b
        return {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
                for k, v in b.items()}

    def grads(dt):
        model = jbuild(cfg_of(dt), mesh=mesh)
        params = placed(model, {k: jnp.asarray(v).astype(dt)
                                for k, v in w.items()})
        batch = batch_of(batches[0])
        _, g = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, batch), has_aux=True))(params)
        return {k: np.asarray(v.astype(jnp.float32)) for k, v in g.items()}

    if mesh is None:
        save(out / f"{name}_g32.npz", grads("float32"))
        save(out / f"{name}_g1.npz", grads("bfloat16"))
    else:
        save(out / f"{name}_mesh_{part}.npz", grads("bfloat16"))
    if name == "llama":
        model = jbuild(cfg_of("bfloat16"), mesh=mesh)
        _, step = jstep(model, JOpt(), mesh=mesh,
                        rules=None if mesh is None else jrules(False))
        params = placed(model, {k: jnp.asarray(v).astype(jnp.bfloat16)
                                for k, v in w.items()})
        state = dict(params=params, **jadamw_init(params))
        steps = []
        for b in batches:
            state, met = step(state, batch_of(b))
            steps.append((float(met["loss"]), float(met["grad_norm"])))
        (out / f"llama_{part}.json").write_text(json.dumps(steps))


# ---------------------------------------------------------------------------
# launching


def _env(**over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               OMP_NUM_THREADS="1", **over)
    return env


def _join(procs) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Both packages' gradients and steps, written under the returned
    directory: the JAX subprocesses and the port's ranks at once."""
    root = tmp_path_factory.mktemp("rule")
    make_problems(root)
    for sub in ("port", "jax"):
        (root / sub).mkdir()
    mod = "from test_torch_bf16_mesh_rule import "
    jaxp = [subprocess.Popen(
        [sys.executable, "-c", mod + "jax_main; import sys; "
         "jax_main(*sys.argv[1:])", str(root), name, part],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in CFGS for part in ("single", *TAGS)]
    ranks = [subprocess.Popen(
        [sys.executable, "-c", mod + "rank_main; import sys; "
         "rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])", str(r),
         str(root / "store"), str(root)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    for who, procs in (("rank", ranks), ("jax", jaxp)):
        for i, (log, p) in enumerate(zip(_join(procs), procs)):
            assert p.returncode == 0, f"{who} {i}:\n{log[-4000:]}"
    return root


def readings(root: Path, name: str) -> dict:
    """Per package and mesh (and the port's controls), each leaf's and the
    whole gradient's (d1, dm, |g32|)."""
    out = {}
    for pkg in ("jax", "port"):
        g32, g1 = (load(root / pkg / f"{name}_{g}.npz") for g in ("g32",
                                                                   "g1"))
        runs = RUNS if (pkg, name) == ("port", "zamba2") else ("mesh",)
        for run in runs:
            for tag in TAGS:
                gm = load(root / pkg / f"{name}_{run}_{tag}.npz")
                assert set(gm) == set(g32) == set(g1)
                out[(pkg, run, tag)] = distances(g32, g1, gm)
    return out


def r_of(dist: dict) -> dict:
    return {k: ratio(d1, dm) for k, (d1, dm, _) in dist.items()}


# ---------------------------------------------------------------------------
# the tests


@pytest.mark.parametrize("name", list(CFGS))
def test_readings_recorded(root, name):
    """Every reading, printed as one JSON line: per package, mesh and run,
    each leaf's d1, dm, |g32| and r; llama's losses and grad norms a step
    in both packages."""
    got = readings(root, name)
    rec = {" ".join(k): {leaf: dict(d1=d1, dm=dm, g32=n32,
                                    r=ratio(d1, dm))
                         for leaf, (d1, dm, n32) in v.items()}
           for k, v in got.items()}
    if name == "llama":
        port = json.loads((root / "port" / "res.json").read_text())
        jres = {f"llama_{t}": json.loads((root / "jax" / f"llama_{t}.json")
                                         .read_text())
                for t in ("single", *TAGS)}
        rec["steps"] = {pkg: {k: v for k, v in res.items()
                              if k.startswith("llama_")}
                        for pkg, res in (("jax", jres), ("port", port))}
        for pkg, res in rec["steps"].items():
            assert set(res) == {"llama_single", "llama_2x2", "llama_1x4"}
            assert all(len(v) == LLAMA_STEPS and all(
                math.isfinite(x) for s in v for x in s)
                for v in res.values()), (pkg, res)
    print(json.dumps({name: rec}))
    assert all(math.isfinite(d) for v in got.values()
               for t in v.values() for d in t)


def test_one_device_bf16_w_in_is_rounding_enough(root):
    """The config is deep enough that one device's bf16 ``w_in`` gradient
    lies at least 10 % from fp32's in both packages."""
    got = readings(root, "zamba2")
    for pkg in ("jax", "port"):
        d1, _, n32 = got[(pkg, "mesh", "2x2")]["layers/mamba/w_in"]
        assert d1 >= 0.1 * n32, (pkg, d1, n32)


@pytest.mark.parametrize("tag", TAGS)
def test_jax_sharded_step_meets_its_own_rule(root, tag):
    """r_ref as read: the JAX package's own GSPMD step, against its own
    one-device bf16 and fp32 steps; recorded with the leaves past the
    plain rule (the port's gate widens by max(1, r_ref) there)."""
    dist = readings(root, "zamba2")[("jax", "mesh", tag)]
    r = r_of(dist)
    print(json.dumps({f"jax {tag}": dict(
        r_max=max(r.values()), past_plain_rule=sorted(misses(dist))),
        "r_ref": r}))
    assert all(math.isfinite(v) for v in r.values()), r


@pytest.mark.parametrize("tag", TAGS)
def test_port_split_step_meets_the_rule(root, tag):
    """(a): the port's split step within 1.25 max(1, r_ref) d1 + 1e-3
    |g32| of fp32 on every leaf and on the whole gradient."""
    got = readings(root, "zamba2")
    r_ref = r_of(got[("jax", "mesh", tag)])
    dist = got[("port", "mesh", tag)]
    print(json.dumps({f"port {tag}": dict(
        r=r_of(dist), past_plain_rule=sorted(misses(dist)))}))
    assert not misses(dist, r_ref), (tag, misses(dist, r_ref),
                                     r_of(dist))


@pytest.mark.parametrize("tag", TAGS)
def test_missing_partial_sum_fails_the_rule(root, tag):
    """(b): the mutation control, the replicated leaves' partial gradients
    not summed over "model", fails the rule: it has power."""
    got = readings(root, "zamba2")
    r_ref = r_of(got[("jax", "mesh", tag)])
    missed = misses(got[("port", "nosum", tag)], r_ref)
    assert missed, tag
    assert set(missed) <= {f"layers/mamba/{k}" for k in (
        "conv_w", "conv_b", "dt_bias", "a_log", "d")} | {"whole"}, missed


@pytest.mark.parametrize("tag", TAGS)
def test_bf16_carried_state_recorded(root, tag):
    """(c): the split path with the SSD scan's carried state in bf16 each
    chunk, recorded (no gate): its r per leaf and the leaves past the
    rule."""
    got = readings(root, "zamba2")
    r_ref = r_of(got[("jax", "mesh", tag)])
    dist = got[("port", "bf16carry", tag)]
    print(json.dumps({f"bf16carry {tag}": dict(
        r=r_of(dist), past_rule=sorted(misses(dist, r_ref)))}))
    assert all(math.isfinite(d) for t in dist.values() for d in t)
