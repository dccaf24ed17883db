"""The port's repo lint (`repro_torch.analysis.lint`) against the JAX
package's (`repro.analysis.lint`): JAX's rule snippets give the same
findings under both, each torch spelling fires its rule, a seeded draw
does not, the port's tree is clean, and the port's lint over the JAX
package equals JAX's own."""
import pathlib

import pytest

from repro_torch.analysis.lint import RULES, lint_paths, lint_source

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: JAX's lint snippets (tests/test_analysis.py), with the path each is
#: linted under (None: a library module outside every scoped directory)
_KERN = "src/repro/kernels/fused_snn_net/ops.py"
JAX_SNIPPETS = [
    ("def f(x):\n    assert x > 0\n", None),
    ("def f(x):\n    assert x > 0  # noqa: ANA001\n", None),
    ("import numpy as np\nv = np.clip(v, V_MIN, V_MAX)\n", None),
    ("v = jnp.clip(v, -1024, 1023)\n", None),
    ("w = (v - V_MIN) % V_SPAN\n", None),
    ("import numpy as np\nv = np.clip(v, V_MIN, V_MAX)\n",
     "src/repro/core/quant.py"),
    ("v = np.clip(v, 0.0, 1.0)\n", None),
    ("import numpy as np\nx = np.random.rand(3)\n", None),
    ("r = np.random.default_rng()\n", None),
    ("r = np.random.default_rng(0)\n", None),
    ("r = np.random.default_rng(seed)\n", None),
    ("y = x.astype(jnp.float32)\n", _KERN),
    ('y = x.astype("float32")\n', _KERN),
    ("y = x.astype(float)\n", _KERN),
    ("y = jnp.zeros(4, dtype=np.bfloat16)\n", _KERN),
    ("y = x.astype(jnp.float32)\n", "src/repro/core/isa.py"),
    ("y = x.astype(jnp.int32)\n", _KERN),
    ("def f(x: float) -> float:\n    return x\n", _KERN),
    ("y = x.astype(jnp.float32)\n", "src/repro/core/quant.py"),
    ("y = x.astype(jnp.float32)  # noqa: ANA005\n", _KERN),
    ("def run(a, b):\n    return a\n", "src/repro/core/pipeline.py"),
    ('def run(a, b):\n    """Runs a."""\n    return a\n',
     "src/repro/serve/x.py"),
]


def _rules(src, path):
    return [v.rule for v in lint_source(src, path)]


@pytest.mark.parametrize("i", range(len(JAX_SNIPPETS)))
def test_jax_snippets_give_jax_findings(i):
    from repro.analysis.lint import lint_source as jax_lint_source
    src, path = JAX_SNIPPETS[i]
    path = path or "src/repro/models/x.py"
    want = [(v.line, v.col, v.rule) for v in jax_lint_source(src, path)]
    got = [(v.line, v.col, v.rule) for v in lint_source(src, path)]
    assert got == want


_TKERN = "src/repro_torch/kernels/fused_snn_net/ops.py"
TORCH_FIRES = [
    ("v = torch.clamp(v, V_MIN, V_MAX)\n", None, "ANA002"),
    ("v = torch.clip(v, -1024, 1023)\n", None, "ANA002"),
    ("v = v.clamp(V_MIN, V_MAX)\n", None, "ANA002"),
    ("v = torch.clamp_min(v, V_MIN)\n", None, "ANA002"),
    ("v = v.clamp(max=V_MAX)\n", None, "ANA002"),
    ("w = torch.remainder(v - V_MIN, V_SPAN)\n", None, "ANA002"),
    ("x = torch.rand(3)\n", None, "ANA003"),
    ("x = torch.randint(0, 4, (3,))\n", None, "ANA003"),
    ("x = torch.randperm(5)\n", None, "ANA003"),
    ("x = torch.bernoulli(p)\n", None, "ANA003"),
    ("x = torch.multinomial(p, 2)\n", None, "ANA003"),
    ("x = torch.normal(0.0, 1.0, (3,))\n", None, "ANA003"),
    ("w.normal_(0.0, 1.0)\n", None, "ANA003"),
    ("y = x.to(torch.float32)\n", _TKERN, "ANA005"),
    ("y = x.float()\n", _TKERN, "ANA005"),
    ("y = x.double()\n", "src/repro_torch/core/isa.py", "ANA005"),
    ("y = x.half()\n", "src/repro_torch/core/macro.py", "ANA005"),
    ("y = x.bfloat16()\n", _TKERN, "ANA005"),
    ("y = torch.zeros(4, dtype=torch.float64)\n", _TKERN, "ANA005"),
    ("y = torch.zeros(4, dtype=torch.float)\n", _TKERN, "ANA005"),
    ("def run(program, xs):\n    return xs\n",
     "src/repro_torch/core/pipeline.py", "ANA004"),
    ('def run(program, xs):\n    """Runs it."""\n    return xs\n',
     "src/repro_torch/serve/x.py", "ANA004"),
]


@pytest.mark.parametrize("src,path,rule", TORCH_FIRES)
def test_torch_spelling_fires_its_rule(src, path, rule):
    assert _rules(src, path or "src/repro_torch/models/x.py") == [rule]
    assert rule in RULES


TORCH_QUIET = [
    ("g = torch.Generator().manual_seed(0)\nx = torch.rand(3, generator=g)\n",
     None),
    ("x = torch.randint(0, 4, (3,), generator=g)\n", None),
    ("w.normal_(0.0, 1.0, generator=g)\n", None),
    ("v = torch.clamp(v, V_MIN, V_MAX)\n", "src/repro_torch/core/quant.py"),
    ("v = torch.clamp(v, 0, 1)\n", None),
    ("y = x.to(torch.int32)\n", _TKERN),
    ("y = x.float()\n", "src/repro_torch/core/quant.py"),
    ("y = x.to(torch.float64)  # noqa: ANA005\n", _TKERN),
    ('def run(program, xs):\n    """``program`` on ``xs``."""\n    '
     'return xs\n', "src/repro_torch/core/pipeline.py"),
]


@pytest.mark.parametrize("src,path", TORCH_QUIET)
def test_seeded_and_scoped_code_is_quiet(src, path):
    assert _rules(src, path or "src/repro_torch/models/x.py") == []


def test_port_tree_is_lint_clean():
    assert lint_paths([ROOT / "src" / "repro_torch"]) == []


def test_port_lint_of_the_jax_package_equals_jax_lint():
    from repro.analysis.lint import lint_paths as jax_lint_paths
    root = ROOT / "src" / "repro"
    want = [str(v) for v in jax_lint_paths([root])]
    assert [str(v) for v in lint_paths([root])] == want
