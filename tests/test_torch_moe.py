"""The port's MoE FFN (`repro_torch.models.layers.init_moe`/`moe_ffn`), the
llama4-maverick dense/MoE super-block model and its serving engine against
the JAX package's, on the CPU.

Setups: `reduced_config("llama4-maverick-400b-a17b")` (4 experts, top-1,
one shared expert, expert d_ff 64) and `tests/test_moe_dispatch.py`'s
(8 experts, top-2, no shared expert, d_model 64, expert d_ff 32). JAX draws
the parameters (`init_moe`, `lm.init_params`); `lm.params_from_jax` carries
them across, and the inputs are drawn from a numpy seed.

Tolerances:
  * float32: every output within 1e-5 * max|JAX| + 1e-6 elementwise (the
    two sides sum float32 products in other orders), the load-balance aux
    within 1e-6 relative. The routing (experts, capacity drops) is then the
    same: a token sent to another expert or dropped moves its output by
    the size of an expert's output, far above that tolerance.
  * bfloat16: relative L2 of the output at most 1e-2 and its largest
    elementwise error at most 2e-2 of max|JAX| (XLA keeps a fused bf16
    elementwise chain in float32 and rounds once, torch rounds after every
    op; about 0.4 to 0.8 % of max|JAX| measured); the aux (float32 router)
    within 1e-6 relative.
  * the model: logits within the float32 tolerance above, the bf16 K/V
    cache within one bf16 ulp plus that tolerance, the loss within 1e-5
    relative and every gradient leaf within 1e-4 relative L2, as
    `tests/test_torch_lm_dense.py` and `tests/test_torch_lm_train.py` hold
    the dense family. Served tokens are compared for equality.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallel  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.launch import serve as jax_serve_launch  # noqa: E402
from repro.launch import train as jax_train_launch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import (MoEConfig, ParallelConfig,  # noqa: E402
                                      get_config, reduced_config)
from repro_torch.data import loader  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import tree_leaves  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths,  # noqa: E402
                              tree_map, tree_unflatten_like)

ARCH = "llama4-maverick-400b-a17b"
RTOL, ATOL = 1e-5, 1e-6
AUX_RTOL = 1e-6
BF16_RL2, BF16_MAX = 1e-2, 2e-2
BF16_ULP = 2.0 ** -7
LOSS_RTOL, GRAD_RL2 = 1e-5, 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def moe_configs(name: str):
    """(JAX config, port config) of a MoE FFN setup."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    if name == "dispatch":                       # test_moe_dispatch's _setup
        jcfg = dataclasses.replace(jcfg, d_model=64, moe=JaxMoE(
            n_experts=8, top_k=2, n_shared_experts=0, d_ff=32))
        cfg = dataclasses.replace(cfg, d_model=64, moe=MoEConfig(
            n_experts=8, top_k=2, n_shared_experts=0, d_ff=32))
    return jcfg, cfg


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return lm.params_from_jax(np_tree(tree), device="cpu")


def moe_params(name: str, dtype: str, seed: int = 0):
    jcfg, _ = moe_configs(name)
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg, dtype=DTYPES[dtype][1])
    return jp, carry(jp)


def inputs(shape, dtype: str, seed: int = 1):
    """(JAX x, port x) of ``shape``, 0.5 * standard normal from a numpy
    seed, rounded to ``dtype`` once on the JAX side and carried across."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.5
    jx = jnp.asarray(x, DTYPES[dtype][1])
    return jx, carry(jx)


def assert_out_close(got, want, dtype: str):
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


def assert_aux_close(got, want):
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=AUX_RTOL)


def drops(x, p, cfg, capacity_factor: float, groups=None) -> int:
    """The number of (token, choice) pairs past their expert's capacity,
    counted from the port's router output with the per-group token order
    (an independent count: no sort)."""
    m = cfg.moe
    B, T, d = x.shape
    G = groups if groups else (B if T > 1 else 1)
    n = B * T // G
    probs = torch.softmax(x.reshape(G, n, d).float() @ p["router"], -1)
    eidx = L._topk_first(probs, m.top_k)[1].reshape(G, n * m.top_k)
    cap = max(int(np.ceil(n * m.top_k / m.n_experts * capacity_factor)), 4)
    counts = torch.stack([torch.bincount(e, minlength=m.n_experts)
                          for e in eidx])
    return int((counts - cap).clamp(min=0).sum())


# -- configs and the parameter layout -----------------------------------------

def test_config_and_param_counts_match_jax():
    """The config's fields equal JAX's, full and reduced, and so do
    `param_count` (400,711,843,840) and `active_param_count`
    (17,184,686,080)."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (reduced_config(get_config(ARCH)),
                          jax_reduced(jax_get_config(ARCH)))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert [ours.is_moe_layer(i) for i in range(ours.n_layers)] == [
            theirs.is_moe_layer(i) for i in range(theirs.n_layers)]
    full = get_config(ARCH)
    assert (full.param_count(), full.active_param_count()) == (
        400_711_843_840, 17_184_686_080)
    assert {f.name for f in dataclasses.fields(MoEConfig)} == {
        f.name for f in dataclasses.fields(JaxMoE)}
    assert ParallelConfig().moe_gather_dispatch is False


def shapes(tree):
    return lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       tree)


def jax_shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  tree)


def test_full_width_params_have_the_jax_layout():
    """`init_moe` and `lm.init_params` at full width (on ``meta``) have
    JAX's tree, shapes and types: 24 super-blocks of a dense layer
    (``pos0``, d_ff 16,384) and a MoE layer (``pos1``: float32 router,
    stacked (128, 5120, 8192) experts, the shared expert)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    got = shapes(L.init_moe(None, cfg))
    want = jax_shapes(jax.eval_shape(
        lambda: JL.init_moe(jax.random.PRNGKey(0), jcfg)))
    assert got == want
    assert got["experts"]["gate"] == ((128, 5120, 8192), "bfloat16")
    assert got["router"] == ((5120, 128), "float32")
    got = shapes(lm.init_params(0, cfg, device="meta"))
    want = jax_shapes(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    assert got == want
    assert got["blocks"]["pos0"]["ffn"]["up"] == ((24, 5120, 16384),
                                                   "bfloat16")
    assert lm.super_period(cfg) == 2 and lm.n_super(cfg) == 24


def test_init_draws_experts_one_at_a_time_into_the_stack():
    """`lm.init_params` draws a MoE layer straight into its slot of the
    stacked tree (`lm._draw_block_`), the expert leaves one expert at a
    time (no float32 draw of a whole stacked leaf) with JAX's fan-in
    scale, and the draws equal a fresh `_init_block` (`init_moe`) from the
    same seed."""
    _, cfg = moe_configs("llama4")
    fresh = lm._init_block(torch.Generator().manual_seed(4), cfg, 1,
                           torch.bfloat16)
    assert "moe" in fresh
    slot = tree_map(torch.empty_like, fresh)
    shapes_seen = []
    real = L.normal

    def recording(gen, shape):
        shapes_seen.append(tuple(shape))
        return real(gen, shape)
    try:
        L.normal = recording
        lm._draw_block_(torch.Generator().manual_seed(4), cfg, 1,
                        torch.bfloat16, slot)
    finally:
        L.normal = real
    m = cfg.moe
    d, E, f, fs = cfg.d_model, m.n_experts, m.d_ff, m.d_ff * m.n_shared_experts
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    assert shapes_seen == ([(d, q), (d, kv), (d, kv), (q, d), (d, E)]
                           + [(d, f)] * 2 * E + [(f, d)] * E
                           + [(d, fs), (d, fs), (fs, d)])
    for a, b in zip(tree_leaves(slot), tree_leaves(fresh)):
        assert torch.equal(a, b)
    # the stacked leaf's spread is JAX's 1 / sqrt(n_experts), not 1/sqrt(d)
    std = float(fresh["moe"]["experts"]["gate"].float().std())
    assert std == pytest.approx(1 / np.sqrt(m.n_experts), rel=0.05)
    params = lm.init_params(4, reduced_config(get_config(ARCH)),
                            device="cpu")
    again = lm.init_params(4, reduced_config(get_config(ARCH)),
                           device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)
    assert params["blocks"]["pos1"]["moe"]["experts"]["gate"].abs().sum() > 0


# -- moe_ffn against JAX ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("shape", [(2, 32), (8, 1)], ids=["T32", "T1"])
@pytest.mark.parametrize("name", ["llama4", "dispatch"])
def test_moe_ffn_matches_jax(name, shape, capacity_factor, gather, dtype):
    """Output and load-balance aux of both dispatch forms against JAX's
    `moe_ffn`, with drops (capacity factor 1.0) and without (8.0), at
    T = 32 (one group per row) and T = 1 (one group over the batch)."""
    jcfg, cfg = moe_configs(name)
    jp, p = moe_params(name, dtype)
    jx, x = inputs(shape + (cfg.d_model,), dtype)
    jout, jlb = JL.moe_ffn(jx, jp, jcfg, capacity_factor=capacity_factor,
                           gather_dispatch=gather)
    out, lb = L.moe_ffn(x, p, cfg, capacity_factor=capacity_factor,
                        gather_dispatch=gather)
    assert out.dtype == x.dtype
    assert_out_close(out, jout, dtype)
    assert_aux_close(lb, jlb)
    dropped = drops(x, p, cfg, capacity_factor)
    if capacity_factor == 8.0:
        assert dropped == 0
    elif shape == (2, 32):
        assert dropped > 0


@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
@pytest.mark.parametrize("name", ["llama4", "dispatch"])
def test_moe_ffn_groups_argument_matches_jax(name, gather):
    """An explicit ``groups`` (4 groups over 2 rows of 32) against JAX."""
    jcfg, cfg = moe_configs(name)
    jp, p = moe_params(name, "float32")
    jx, x = inputs((2, 32, cfg.d_model), "float32", seed=2)
    jout, jlb = JL.moe_ffn(jx, jp, jcfg, capacity_factor=1.0, groups=4,
                           gather_dispatch=gather)
    out, lb = L.moe_ffn(x, p, cfg, capacity_factor=1.0, groups=4,
                        gather_dispatch=gather)
    assert_out_close(out, jout, "float32")
    assert_aux_close(lb, jlb)


@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
@pytest.mark.parametrize("name", ["llama4", "dispatch"])
def test_ties_and_sort_stability_decide_as_in_jax(name, gather):
    """Adversarial routing. A zero router ties every probability: top-k
    takes the lowest expert indices (``lax.top_k``'s order), every token
    goes to the same k experts, and the stable sort keeps the first
    ``cap`` tokens of each in token order; the rest get only the shared
    expert. Then a random router over duplicated token rows: copies of
    one row tie in the sort, and stability decides which copies keep a
    slot. Both against JAX, in float32."""
    jcfg, cfg = moe_configs(name)
    jp, p = moe_params(name, "float32", seed=7)
    m = cfg.moe
    jp0 = dict(jp, router=jnp.zeros_like(jp["router"]))
    p0 = dict(p, router=torch.zeros_like(p["router"]))
    jx, x = inputs((2, 32, cfg.d_model), "float32", seed=3)
    jout, jlb = JL.moe_ffn(jx, jp0, jcfg, capacity_factor=1.0,
                           gather_dispatch=gather)
    out, lb = L.moe_ffn(x, p0, cfg, capacity_factor=1.0,
                        gather_dispatch=gather)
    assert_out_close(out, jout, "float32")
    assert_aux_close(lb, jlb)
    cap = max(int(np.ceil(32 * m.top_k / m.n_experts)), 4)
    shared = (L.ffn(x, p["shared"], "swiglu") if "shared" in p
              else torch.zeros_like(x))
    assert torch.equal(out[:, cap:], shared[:, cap:])     # overflowed
    assert not torch.allclose(out[:, :cap], shared[:, :cap])

    rows = np.random.default_rng(5).standard_normal((4, cfg.d_model))
    dup = np.repeat(rows, 16, axis=0)[np.random.default_rng(6).permutation(
        64)].reshape(2, 32, cfg.d_model).astype(np.float32)
    jx, x = jnp.asarray(dup), torch.from_numpy(dup)
    jout, jlb = JL.moe_ffn(jx, jp, jcfg, capacity_factor=1.0,
                           gather_dispatch=gather)
    out, lb = L.moe_ffn(x, p, cfg, capacity_factor=1.0,
                        gather_dispatch=gather)
    assert drops(x, p, cfg, 1.0) > 0
    assert_out_close(out, jout, "float32")
    assert_aux_close(lb, jlb)


def test_topk_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.25, 0.5, 0.5, 0.25, 0.5]])
    vals, idx = L._topk_first(probs, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[0.5, 0.5, 0.5]]
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
def test_dispatch_forms_agree_in_the_port_with_grads(gather):
    """The port's output and gradients with either ``gather_dispatch``
    equal JAX's for that dispatch form (float32, drops on): the port's one
    dispatch computes both forms' function and its derivatives. Gradient
    leaves within 1e-4 relative L2."""
    jcfg, cfg = moe_configs("dispatch")
    jp, p = moe_params("dispatch", "float32", seed=5)
    jx, x = inputs((2, 32, cfg.d_model), "float32", seed=4)

    def jloss(q):
        out, lb = JL.moe_ffn(jx, q, jcfg, capacity_factor=1.0,
                             gather_dispatch=gather)
        return (out ** 2).sum() + lb
    jgrads = jax.tree_util.tree_leaves(jax.grad(jloss)(jp))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    out, lb = L.moe_ffn(x, tree_unflatten_like(p, leaves), cfg,
                        capacity_factor=1.0, gather_dispatch=gather)
    grads = torch.autograd.grad((out ** 2).sum() + lb, leaves)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        g, jg = g.numpy(), np.asarray(jg)
        assert g.shape == jg.shape and np.isfinite(g).all()
        assert np.linalg.norm(g - jg) <= 1e-4 * np.linalg.norm(jg) + 1e-12


# -- the reduced llama4 model against JAX --------------------------------------

_MODEL: dict = {}


def model():
    """JAX float32 params (PRNGKey(0)) of reduced llama4 (a dense layer and
    a MoE layer) and the port's copy."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    if not _MODEL:
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        _MODEL["p"] = (jp, carry(jp))
    return jcfg, cfg, *_MODEL["p"]


def close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()) + ATOL, err


def close_kv(got, want, n=None):
    """bf16 K/V within one bf16 ulp of each value plus the float32
    tolerance of the leaf, at positions below ``n``."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if n is not None:
        got, want = got[:, :, :n], want[:, :, :n]
    tol = BF16_ULP * np.abs(want) + RTOL * np.abs(want).max() + ATOL
    assert (np.abs(got - want) <= tol).all()


def tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def test_init_cache_has_the_jax_layout():
    jcfg, cfg, _, _ = model()
    got = shapes(lm.init_cache(cfg, 3, 32, device="cpu"))
    assert got == jax_shapes(jlm.init_cache(jcfg, 3, 32))
    assert set(got["blocks"]) == {"pos0", "pos1"}


def test_prefill_matches_jax():
    jcfg, cfg, jp, p = model()
    t = tokens(24, seed=1)
    jlogits, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(t)}, jcfg, 32)
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg, 32)
    close(logits, jlogits)
    for pos in ("pos0", "pos1"):
        for kv in ("k", "v"):
            close_kv(cache["blocks"][pos][kv],
                     jcache["blocks"][pos][kv], n=24)
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()


@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
def test_padded_prefill_matches_jax_padded_prefill(gather):
    """A 13-token prompt right-padded to 16 with its true length against
    JAX's padded prefill: the padding is routed too (the MoE capacity
    grows with the padded length), so the oracle is JAX's padded prefill,
    not the port's exact one."""
    jcfg, cfg, jp, p = model()
    t = np.zeros((1, 16), np.int64)
    t[0, :13] = tokens(13, seed=2)
    jpar = JaxParallel(remat="none", moe_gather_dispatch=gather)
    par = ParallelConfig(remat="none", moe_gather_dispatch=gather)
    jlogits, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(t)}, jcfg, 32,
                                  jpar, length=jnp.int32(13))
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg,
                                   32, par, length=13)
    close(logits, jlogits)
    close_kv(cache["blocks"]["pos1"]["k"], jcache["blocks"]["pos1"]["k"],
             n=13)
    assert cache["len"].tolist() == [13]


def test_decode_step_matches_jax():
    """Three decode steps of 4 lanes at different lengths from JAX's own
    cache (carried across), one routing group over the lanes."""
    jcfg, cfg, jp, p = model()
    rng = np.random.default_rng(3)
    jcache = jlm.init_cache(jcfg, 4, 32)
    jcache = dict(jcache, len=jnp.asarray([3, 7, 1, 12], jnp.int32))
    ks = jax.random.split(jax.random.PRNGKey(9), 4)
    blocks = jax.tree_util.tree_map(
        lambda a, k: (jax.random.normal(k, a.shape) * 0.3).astype(a.dtype),
        jcache["blocks"], {"pos0": {"k": ks[0], "v": ks[1]},
                           "pos1": {"k": ks[2], "v": ks[3]}})
    jcache["blocks"] = blocks
    cache = carry(jcache)
    for step in range(3):
        t = rng.integers(0, 512, (4, 1))
        jlogits, jcache = jlm.decode_step(jp, jnp.asarray(t), jcache, jcfg)
        with torch.no_grad():
            logits, cache = lm.decode_step(p, torch.as_tensor(t), cache, cfg)
        close(logits, jlogits)
        assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    for pos in ("pos0", "pos1"):
        close_kv(cache["blocks"][pos]["v"], jcache["blocks"][pos]["v"])


def port_grads(p, b, cfg, parallel):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    loss, aux = lm.loss_fn(tree_unflatten_like(p, leaves), b, cfg, parallel)
    grads = torch.autograd.grad(loss, leaves)
    paths = [path for path, _ in tree_flatten_with_paths(p)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(
        zip(paths, grads))


def rel_l2(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_jax(remat):
    """`lm.loss_fn`'s loss, ``ce`` and ``aux`` (the MoE layer's
    load-balance loss) and every gradient leaf against
    `jax.value_and_grad` of JAX's (remat off there; the port's remat must
    not change them)."""
    jcfg, cfg, jp, p = model()
    b = loader.lm_batch_fn(512, 4, 32, 0)(0, 0, 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jb, jcfg, JaxParallel(remat="none", fsdp=False,
                                  seq_parallel=False))
    loss, aux, grads = port_grads(p, b, cfg, ParallelConfig(remat=remat))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(aux["ce"]) == pytest.approx(float(jaux["ce"]), rel=LOSS_RTOL)
    assert float(aux["aux"]) == pytest.approx(float(jaux["aux"]),
                                              rel=LOSS_RTOL)
    assert float(aux["aux"]) > 0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    bad = {}
    for (path, g), jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape, path
        if not rel_l2(g, jg) <= GRAD_RL2:
            bad["/".join(map(str, path))] = rel_l2(g, jg)
    assert not bad, bad


# -- the serving engine against the unmodified JAX engine ----------------------

def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return sorted(eng.run_until_drained(), key=lambda r: r.rid)


class EagerEngine(ServeEngine):
    _compiled = False


def test_engine_matches_unmodified_jax_engine(monkeypatch):
    """14 requests of 3 to 40 tokens through 8 slots, 5 to 9 new tokens
    each, bucketing on: prompts prefill padded to JAX's buckets (the
    padding is routed), and every decode tick routes all 8 lanes, idle and
    finished ones included, in one group (capacity 4 of 4 experts, so the
    lanes compete for it). The compiled and the eager port engines serve
    JAX's tokens and fill JAX's buckets."""
    jcfg, cfg, jp, p = model()
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, 512, int(rng.integers(3, 41))) for _ in range(14)]
    news = [int(rng.integers(5, 10)) for _ in range(14)]
    jeng = JaxEngine(jp, jcfg, batch_slots=8, max_len=64)
    assert jeng._bucket_prompts
    want = drain(jeng, [JaxRequest(rid=i, prompt=x, max_new_tokens=k)
                        for i, (x, k) in enumerate(zip(ps, news))])
    for cls in (ServeEngine, EagerEngine):
        eng = cls(p, cfg, batch_slots=8, max_len=64)
        assert eng._bucket_prompts == jeng._bucket_prompts
        got = drain(eng, [Request(rid=i, prompt=x, max_new_tokens=k)
                          for i, (x, k) in enumerate(zip(ps, news))])
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
        assert list(eng._prefill_cache) == list(jeng._prefill_cache)
    # the drain really overflowed: count each MoE call's drops (decode: 8
    # lanes in one group over 4 experts, cap 4) in an eager rerun
    seen = []
    real = L.moe_ffn

    def counting(x, p_moe, c, **kw):
        seen.append((x.shape[1], drops(x, p_moe, c, 1.25)))
        return real(x, p_moe, c, **kw)
    monkeypatch.setattr(L, "moe_ffn", counting)
    drain(EagerEngine(p, cfg, batch_slots=8, max_len=64),
          [Request(rid=i, prompt=x, max_new_tokens=k)
           for i, (x, k) in enumerate(zip(ps, news))])
    assert any(t == 1 and n > 0 for t, n in seen)        # a decode tick
    assert any(t > 1 and n > 0 for t, n in seen)         # a prefill


# -- the launchers --------------------------------------------------------------

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
    assert [ln.split(" loss ")[0] for ln in got[:2]] == ["step 1", "step 5"]
    assert got[-1] == want[-1]
    loss = float(got[1].split(" loss ")[1].split()[0])
    assert np.isfinite(loss)
    assert res.state.params["blocks"]["pos1"]["moe"]["experts"][
        "gate"].shape == (1, 4, 128, 64)
