"""The check that no JAX module is loaded compares top-level names whole:
the port's name begins with the JAX package's."""

from kpcabench.common import forbidden_modules


def test_top_level_names_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1,
            "jaxtyping": 1, "flaxen.x": 1, "numpy": 1}
    assert forbidden_modules(mods) == []
    mods.update({"repro": 1, "repro.core.admm": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                       "repro", "repro.core.admm"]


def test_the_harness_and_the_port_load_no_jax():
    import subprocess
    import sys
    from kpcabench.common import ROOT
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import kpcabench.run, kpcabench.control, kpcabench.tracing;"
            "import kpcabench.runners.fit, kpcabench.runners.serve;"
            "import kpcabench.runners.ring_fit, kpcabench.runners.train;"
            "import kpcabench.lm_checks, kpcabench.lm_reference.hybrid;"
            "import repro_torch.models, repro_torch.train;"
            "import repro_torch.core, repro_torch.serve, repro_torch.launch;"
            "from kpcabench.common import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
