"""The port's deepseek-v2-lite pieces against the JAX package's, on the CPU:
multi-head latent attention (`layers.init_mla`/`mla_attention` and its
latent cache), the ``first_k_dense`` prelude of `lm`, the MoE combine of
k > 2 contributions, the model, its serving engine and the launchers.

Setups: `reduced_config("deepseek-v2-lite-16b")` (a dense prelude layer and
two MoE layers of 4 experts, top-2, two shared experts; MLA with a latent
of 32, rope heads of 16, nope and v heads of 32) and a top-6 variant of it
(8 experts). JAX draws the parameters; `lm.params_from_jax` carries them
across, and inputs are drawn from a numpy seed.

Tolerances, as `tests/test_torch_moe.py` states them:
  * float32: every output within 1e-5 * max|JAX| + 1e-6 elementwise; the
    bf16 latent cache within one bf16 ulp of each value plus that
    tolerance; the loss within 1e-5 relative and every gradient leaf
    within 1e-4 relative L2.
  * bfloat16 (`mla_attention` on bf16 weights, `moe_ffn` on a random
    input): relative L2 at most 1e-2 and the largest elementwise error at
    most 2e-2 of max|JAX| (XLA keeps a fused bf16 chain in float32 and
    rounds once, torch rounds after every op).
  * the MoE combine: bit for bit. On an input whose products are exact in
    both packages, so that only the order of the adds can part them, the
    whole top-6 `moe_ffn` equals JAX's bit for bit in bf16.
Served tokens are compared for equality.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import MLAConfig as JaxMLA  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallel  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.launch import serve as jax_serve_launch  # noqa: E402
from repro.launch import train as jax_train_launch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import (MLAConfig, ParallelConfig,  # noqa: E402
                                      get_config, reduced_config)
from repro_torch.data import loader  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import tree_leaves  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths,  # noqa: E402
                              tree_unflatten_like)

ARCH = "deepseek-v2-lite-16b"
RTOL, ATOL = 1e-5, 1e-6
BF16_RL2, BF16_MAX = 1e-2, 2e-2
BF16_ULP = 2.0 ** -7
LOSS_RTOL, GRAD_RL2 = 1e-5, 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the JAX oracles compiled whole (op-by-op dispatch would take minutes);
# the bit-for-bit combine tests call JAX's functions unjitted
jmla = jax.jit(JL.mla_attention, static_argnums=(2,))
jmoe = jax.jit(JL.moe_ffn, static_argnums=(2,),
               static_argnames=("capacity_factor",))
jinit = jax.jit(jlm.init_params, static_argnums=(1, 2))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(3,))
jgrad = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                static_argnums=(2, 3))


def configs(name: str = "top2"):
    """(JAX config, port config): reduced deepseek, or its top-6 variant
    over 8 experts."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    if name == "top6":
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=8, top_k=6))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=6))
    return jcfg, cfg


def carry(tree):
    return lm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")


def both(a, dtype: str = "float32"):
    """A numpy array as a JAX array of ``dtype`` and the port's copy of
    it (rounded once, on the JAX side)."""
    ja = jnp.asarray(a, DTYPES[dtype][1])
    return ja, carry(ja)


def assert_close(got, want, dtype: str = "float32"):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert float(err.max()) <= RTOL * scale + ATOL, float(err.max())
    else:
        rl2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rl2 <= BF16_RL2, rl2
        assert float(err.max()) <= BF16_MAX * scale, float(err.max())


def close_latent(got, want, n=None):
    """A bf16 latent cache within one bf16 ulp of each value plus the
    float32 tolerance of the leaf, at positions below ``n`` (axis -2)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if n is not None:
        got, want = got[..., :n, :], want[..., :n, :]
    tol = BF16_ULP * np.abs(want) + RTOL * np.abs(want).max() + ATOL
    assert (np.abs(got - want) <= tol).all()


def shapes(tree):
    return lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       tree)


def jax_shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  tree)


# -- configs and the parameter layout ------------------------------------------

def test_config_and_param_counts_match_jax():
    """The config's fields equal JAX's, full and reduced, and so do
    `param_count` (15,706,468,352) and `active_param_count`
    (2,661,134,336)."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         configs()[::-1], configs("top6")[::-1]):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert lm.n_prelude(ours) == jlm.n_prelude(theirs) == 1
    full = get_config(ARCH)
    assert (full.param_count(), full.active_param_count()) == (
        15_706_468_352, 2_661_134_336)
    assert {f.name for f in dataclasses.fields(MLAConfig)} == {
        f.name for f in dataclasses.fields(JaxMLA)}
    # the q_lora_rank branch of the count
    lora = (dataclasses.replace(full, mla=MLAConfig(q_lora_rank=1536)),
            dataclasses.replace(jax_get_config(ARCH),
                                mla=JaxMLA(q_lora_rank=1536)))
    assert lora[0].param_count() == lora[1].param_count()


def test_full_width_params_and_cache_have_the_jax_layout():
    """`lm.init_params` on ``meta`` at full width has JAX's tree, shapes
    and types: the prelude (one dense layer, d_ff 10,944) and 26 stacked
    MoE layers (64 experts of 1,408, MLA leaves), every body layer offset
    by the prelude; the cache has the (B, max_len, 576) latent."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    got = shapes(lm.init_params(0, cfg, device="meta"))
    want = jax_shapes(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    assert got == want
    assert got["prelude"][0]["ffn"]["up"] == ((2048, 10944), "bfloat16")
    assert got["blocks"]["pos0"]["moe"]["experts"]["gate"] == (
        (26, 64, 2048, 1408), "bfloat16")
    assert got["blocks"]["pos0"]["attn"]["w_uk"] == ((26, 512, 2048),
                                                      "bfloat16")
    assert got["blocks"]["pos0"]["attn"]["wq"] == ((26, 2048, 3072),
                                                    "bfloat16")
    assert "ffn" not in got["blocks"]["pos0"]
    cache = shapes(lm.init_cache(cfg, 4, 1152, device="meta"))
    assert cache == jax_shapes(jax.eval_shape(
        lambda: jlm.init_cache(jcfg, 4, 1152)))
    assert cache["blocks"]["pos0"]["latent"] == ((26, 4, 1152, 576),
                                                 "bfloat16")


def test_init_draws_the_prelude_and_the_body_into_place():
    """The port's draws from a seed: the same twice, the prelude drawn
    (its dense FFN's spread is 1 / sqrt(d)), every body layer a MoE layer
    drawn in its stacked slot."""
    _, cfg = configs()
    a, b = (lm.init_params(3, cfg, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    up = a["prelude"][0]["ffn"]["up"].float()
    assert float(up.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    gate = a["blocks"]["pos0"]["moe"]["experts"]["gate"]
    assert gate.shape[0] == 2 and all(float(g.abs().sum()) > 0 for g in gate)


# -- mla_attention against JAX ---------------------------------------------------

def mla_params(dtype: str, seed: int = 0):
    jcfg, _ = configs()
    jp = JL.init_mla(jax.random.PRNGKey(seed), jcfg, dtype=DTYPES[dtype][1])
    return jp, carry(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(dtype):
    """Causal prefill of 2 rows of 24 tokens: the output and the latent
    (the compressed c_kv and the rotated rope key)."""
    jcfg, cfg = configs()
    jp, p = mla_params(dtype)
    rng = np.random.default_rng(1)
    jx, x = both(rng.standard_normal((2, 24, cfg.d_model)), dtype)
    pos = np.arange(24)[None]
    want, jlatent = jmla(jx, jp, jcfg, jnp.asarray(pos))
    got, latent = L.mla_attention(x, p, cfg, torch.from_numpy(pos))
    assert got.dtype == x.dtype and latent.shape == (2, 24, 48)
    assert_close(got, want, dtype)
    assert_close(latent, jlatent, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """One decode step of 4 lanes at positions 3, 9, 0 and S (the cache's
    length) against a random bf16 latent cache: the output equals JAX's,
    each lane below S writes its latent row at its position into the
    caller's cache in place, and the lane at S writes nothing (JAX drops
    the update) and attends the whole cache."""
    jcfg, cfg = configs()
    jp, p = mla_params(dtype, seed=1)
    rng = np.random.default_rng(2)
    B, S = 4, 12
    lat = rng.standard_normal((B, S, 48)) * 0.5
    jcache, cache = both(lat, "bfloat16")
    before = cache.clone()
    pos = np.array([3, 9, 0, S], np.int32)
    jx, x = both(rng.standard_normal((B, 1, cfg.d_model)), dtype)
    want, jnew = jmla(jx, jp, jcfg, jnp.asarray(pos)[:, None],
                      latent_cache=jcache, pos=jnp.asarray(pos))
    tpos = torch.from_numpy(pos)
    got, new = L.mla_attention(x, p, cfg, tpos[:, None], latent_cache=cache,
                               pos=tpos)
    assert new is cache
    assert_close(got, want, dtype)
    close_latent(new, jnew)
    written = np.zeros((B, S), bool)
    written[[0, 1, 2], pos[:3]] = True
    keep = torch.from_numpy(~written)
    assert torch.equal(new[keep], before[keep])
    assert not torch.equal(new[0, 3], before[0, 3])


# -- the MoE combine --------------------------------------------------------------

def sorted_assignments(rng, G: int, n: int, k: int, E: int):
    """``order`` of `moe_ffn`: the stable sort of n tokens' k distinct
    expert ids in each of G groups."""
    eidx = np.stack([np.stack([rng.permutation(E)[:k] for _ in range(n)])
                     for _ in range(G)]).reshape(G, n * k)
    return np.argsort(eidx, axis=-1, kind="stable")


def scatter_combine(contrib, order, k):
    """The combine before the fix: `scatter_add_` by token."""
    G, nk, d = contrib.shape
    return torch.zeros((G, nk // k, d), dtype=contrib.dtype).scatter_add_(
        1, (order // k)[..., None].expand(-1, -1, d), contrib)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_combine_adds_in_the_jax_order(k):
    """`_combine` on random bf16 contributions equals JAX's ``.at[g,
    tok].add`` bit for bit for every k; the old `scatter_add_` combine
    equals it for k <= 2 (so the llama4 and dense paths are unchanged) and
    differs from it at k = 6."""
    rng = np.random.default_rng(k)
    G, n, d = 2, 40, 16
    order = sorted_assignments(rng, G, n, k, 8)
    contrib = rng.standard_normal((G, n * k, d)) * np.exp2(
        rng.integers(-8, 1, (G, n * k, 1)))
    jc, tc = both(contrib, "bfloat16")
    want = jnp.zeros((G, n, d), jnp.bfloat16).at[
        jnp.arange(G)[:, None], jnp.asarray(order) // k].add(jc)
    want = carry(want)
    torder = torch.from_numpy(order)
    assert torch.equal(L._combine(tc, torder, k), want)
    old = scatter_combine(tc, torder, k)
    assert torch.equal(old, want) == (k <= 2)


def order_sensitive_moe(rng):
    """(JAX params, port params, JAX x, port x) of a top-6 `moe_ffn` over 8
    experts with two shared experts, in bf16, whose every product is exact
    in both packages: a zero router (every token takes experts 0 to 5 with
    gate 1/6), inputs of 0 and 1 whose first 32 features are 1, ``gate``
    weights of 1 (so silu(g) == g at g >= 32), ``up`` and ``down`` weights
    in {-1, 0, 1}, expert 0's ``down`` at full scale and the others' at
    2^-9. A token's contribution from expert 0 is then hundreds of times
    the others', which fall below half its ulp one by one but not
    together: the order of the adds decides the sum."""
    jcfg, cfg = configs("top6")
    jcfg = dataclasses.replace(jcfg, d_model=64, moe=dataclasses.replace(
        jcfg.moe, d_ff=32))
    cfg = dataclasses.replace(cfg, d_model=64, moe=dataclasses.replace(
        cfg.moe, d_ff=32))
    d, E, f = 64, 8, 32
    ternary = lambda *s: rng.integers(-1, 2, s).astype(np.float32)  # noqa
    scale = np.full((E, 1, 1), 2.0 ** -9, np.float32)
    scale[0] = 1.0
    arrays = {"router": np.zeros((d, E), np.float32),
              "experts": {"gate": np.ones((E, d, f), np.float32),
                          "up": ternary(E, d, f),
                          "down": ternary(E, f, d) * scale},
              "shared": {"gate": np.ones((d, 2 * f), np.float32),
                         "up": ternary(d, 2 * f),
                         "down": ternary(2 * f, d) * 2.0 ** -9}}
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32 if a.shape == (d, E)
                              else jnp.bfloat16), arrays)
    x = rng.integers(0, 2, (2, 16, d)).astype(np.float32)
    x[..., :32] = 1.0
    jx, tx = both(x, "bfloat16")
    return jcfg, cfg, jp, carry(jp), jx, tx


def test_top6_moe_ffn_equals_jax_bit_for_bit_where_order_decides(
        monkeypatch):
    """Top-6 `moe_ffn` in bf16 on `order_sensitive_moe` equals JAX's bit
    for bit (and its aux); the same call with the old `scatter_add_`
    combine in its place does not."""
    jcfg, cfg, jp, p, jx, x = order_sensitive_moe(np.random.default_rng(9))
    want, jlb = JL.moe_ffn(jx, jp, jcfg, capacity_factor=2.0)
    got, lb = L.moe_ffn(x, p, cfg, capacity_factor=2.0)
    want = carry(want)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert float(lb) == pytest.approx(float(jlb), rel=1e-6)
    monkeypatch.setattr(L, "_combine", scatter_combine)
    old, _ = L.moe_ffn(x, p, cfg, capacity_factor=2.0)
    assert not torch.equal(old, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top6_moe_ffn_matches_jax_on_a_random_input(dtype):
    """Top-6 over 8 experts with two shared experts, JAX's own init and a
    random input, with drops (T = 32, capacity factor 1.0) and a decode
    group (T = 1), within the file's tolerance of ``dtype``."""
    jcfg, cfg = configs("top6")
    jp = JL.init_moe(jax.random.PRNGKey(4), jcfg, dtype=DTYPES[dtype][1])
    p = carry(jp)
    rng = np.random.default_rng(5)
    for shape, cf in (((2, 32), 1.0), ((8, 1), 1.25)):
        jx, x = both(rng.standard_normal(shape + (cfg.d_model,)) * 0.5,
                     dtype)
        want, jlb = jmoe(jx, jp, jcfg, capacity_factor=cf)
        got, lb = L.moe_ffn(x, p, cfg, capacity_factor=cf)
        assert_close(got, want, dtype)
        assert float(lb) == pytest.approx(float(jlb), rel=1e-6)


# -- the reduced model against JAX ---------------------------------------------

_MODEL: dict = {}


def model(name: str = "top2"):
    """JAX float32 params (PRNGKey(0)) of a reduced deepseek and the
    port's copy."""
    jcfg, cfg = configs(name)
    if name not in _MODEL:
        jp = jinit(jax.random.PRNGKey(0), jcfg, jnp.float32)
        _MODEL[name] = (jp, carry(jp))
    return jcfg, cfg, *_MODEL[name]


def tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


@pytest.mark.parametrize("name", ["top2", "top6"])
def test_prefill_matches_jax(name):
    """Logits and the prelude's and body's latent caches of a 20-token
    prefill."""
    jcfg, cfg, jp, p = model(name)
    t = tokens(20, seed=1)
    jlogits, jcache = jprefill(jp, {"tokens": jnp.asarray(t)}, jcfg, 32)
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg,
                                   32)
    assert_close(logits, jlogits)
    close_latent(cache["prelude"][0]["latent"],
                 jcache["prelude"][0]["latent"])
    close_latent(cache["blocks"]["pos0"]["latent"],
                 jcache["blocks"]["pos0"]["latent"])
    assert float(cache["blocks"]["pos0"]["latent"][:, :, 20:].abs().sum()) == 0
    assert cache["len"].tolist() == [20]


@pytest.mark.parametrize("name", ["top2", "top6"])
def test_decode_step_matches_jax(name):
    """Three decode steps of 4 lanes at lengths 3, 7, 1 and 32 (= max_len:
    its writes are dropped) from JAX's own random latent caches, carried
    across; the port writes each latent in place."""
    jcfg, cfg, jp, p = model(name)
    rng = np.random.default_rng(3)
    jcache = jlm.init_cache(jcfg, 4, 32)
    keys = iter(jax.random.split(jax.random.PRNGKey(9), 8))
    jcache = jax.tree_util.tree_map(
        lambda a: (jax.random.normal(next(keys), a.shape) * 0.3).astype(
            a.dtype) if a.ndim > 1 else a, jcache)
    jcache["len"] = jnp.asarray([3, 7, 1, 32], jnp.int32)
    cache = carry(jcache)
    leaves = tree_leaves(cache)
    for step in range(3):
        t = rng.integers(0, 512, (4, 1))
        jlogits, jcache = jdecode(jp, jnp.asarray(t), jcache, jcfg)
        with torch.no_grad():
            logits, cache = lm.decode_step(p, torch.as_tensor(t), cache, cfg)
        assert_close(logits, jlogits)
        assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    assert all(a is b for a, b in zip(tree_leaves(cache)[:-1], leaves[:-1])
               if a.dim() > 1)
    close_latent(cache["prelude"][0]["latent"],
                 jcache["prelude"][0]["latent"])
    close_latent(cache["blocks"]["pos0"]["latent"],
                 jcache["blocks"]["pos0"]["latent"])


def rel_l2(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


_JAX_GRADS: dict = {}


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", ["top2", "top6"])
def test_loss_and_gradients_match_jax(name, remat):
    """`lm.loss_fn`'s loss, ``ce`` and ``aux`` (the MoE layers'
    load-balance losses) and every gradient leaf, the prelude's included,
    against `jax.value_and_grad` of JAX's (remat off there; the port's
    remat, which leaves the prelude out, must not change them)."""
    jcfg, cfg, jp, p = model(name)
    b = loader.lm_batch_fn(512, 2, 16, 0)(0, 0, 1)
    if name not in _JAX_GRADS:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        _JAX_GRADS[name] = jgrad(jp, jb, jcfg, JaxParallel(
            remat="none", fsdp=False, seq_parallel=False))
    (jloss, jaux), jgrads = _JAX_GRADS[name]
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    loss, aux = lm.loss_fn(tree_unflatten_like(p, leaves), b, cfg,
                           ParallelConfig(remat=remat))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(aux["ce"]) == pytest.approx(float(jaux["ce"]), rel=LOSS_RTOL)
    assert float(aux["aux"]) == pytest.approx(float(jaux["aux"]),
                                              rel=LOSS_RTOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    paths = [path for path, _ in tree_flatten_with_paths(p)]
    assert len(grads) == len(jleaves)
    assert any(path[0] == "prelude" for path in paths)
    bad = {"/".join(map(str, path)): rel_l2(g, jg)
           for path, g, jg in zip(paths, grads, jleaves)
           if not rel_l2(g, jg) <= GRAD_RL2}
    assert not bad, bad


# -- the serving engine and the launchers ----------------------------------------

class EagerEngine(ServeEngine):
    _compiled = False


def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return sorted(eng.run_until_drained(), key=lambda r: r.rid)


def test_engine_matches_unmodified_jax_engine():
    """7 requests of 5, 11 and 17 tokens through 3 slots, 4 to 7 new
    tokens each: both engines prefill MLA prompts at their exact length
    (no buckets), and the compiled and the eager port engines serve JAX's
    tokens."""
    jcfg, cfg, jp, p = model()
    rng = np.random.default_rng(11)
    lens = [5, 11, 5, 17, 11, 5, 17]
    ps = [rng.integers(0, 512, n) for n in lens]
    news = [int(rng.integers(4, 8)) for _ in lens]
    jeng = JaxEngine(jp, jcfg, batch_slots=3, max_len=48)
    assert not jeng._bucket_prompts
    want = drain(jeng, [JaxRequest(rid=i, prompt=x, max_new_tokens=k)
                        for i, (x, k) in enumerate(zip(ps, news))])
    for cls in (ServeEngine, EagerEngine):
        eng = cls(p, cfg, batch_slots=3, max_len=48)
        assert not eng._bucket_prompts and eng._prefill_bucket(13) == 13
        got = drain(eng, [Request(rid=i, prompt=x, max_new_tokens=k)
                          for i, (x, k) in enumerate(zip(ps, news))])
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
        assert sorted(eng._prefill_cache) == [5, 11, 17]
    assert eng.cache["prelude"][0]["latent"].shape == (3, 48, 48)


NUM = re.compile(r"-?\d+(\.\d+)?")


def masked(lines):
    """Lines with every number and the device name masked."""
    return [NUM.sub("#", ln).replace("on cpu", "on CPU") for ln in lines]


def test_serve_launcher_prints_the_jax_launchers_lines(capsys):
    argv = ["--arch", ARCH, "--requests", "3", "--max-new", "4"]
    jdone = jax_serve_launch.main(argv)
    want = capsys.readouterr().out.splitlines()
    done = serve_launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert masked(got) == masked(want)
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0]
    assert [len(r.out_tokens) for r in done] == [
        len(r.out_tokens) for r in jdone]


def test_train_launcher_prints_the_jax_launchers_lines(capsys):
    argv = ["--arch", ARCH, "--steps", "5", "--batch", "2", "--seq", "16"]
    jax_train_launch.main(argv)
    want = capsys.readouterr().out.splitlines()
    res = train_launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert masked(got) == masked(want)
    assert got[-1] == want[-1]
    assert np.isfinite(float(got[1].split(" loss ")[1].split()[0]))
    params = res.state.params
    assert params["prelude"][0]["ffn"]["up"].shape == (128, 256)
    assert params["blocks"]["pos0"]["attn"]["w_uk"].shape == (2, 32, 128)
