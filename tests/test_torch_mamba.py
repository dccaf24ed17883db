"""The port's Mamba block (`repro_torch.models.mamba`) and jamba's hybrid
super-block (Mamba and attention layers, MoE every 2) against the JAX
package's, on the CPU: the causal conv, the associative scan, the chunked
`mamba_forward` and `mamba_decode`, the init's constant leaves, the cache,
the model's prefill, decode and loss, its serving engine and the
launchers.

Setups: `reduced_config("jamba-v0.1-52b")` (8 layers: attention at place 4,
Mamba elsewhere, MoE of 4 experts at top-2 at the odd places; d_model 128,
SSM state 8, conv 4, expand 2, dt rank 16) and a 16-layer stack of two such
super-blocks. JAX draws the parameters; `lm.params_from_jax` carries them
across, and inputs are drawn from a numpy seed. The JAX oracles are
`jax.jit`-ed.

Tolerances:
  * float32: every output and state within 1e-5 * max|JAX| + 1e-6
    elementwise (the scan combines in JAX's tree, so only the ulps of
    ``exp`` and of the products' sums part the two); the bf16 K/V cache
    within one bf16 ulp of each value plus that tolerance; the loss within
    1e-5 relative and every gradient leaf within 1e-4 relative L2.
  * bfloat16 (the block and the model at small depth, bf16 weights):
    relative L2 at most 1e-2 (XLA keeps a fused bf16 chain in float32 and
    rounds once, torch rounds after every op).
  * the scan's combine tree: bit for bit, on a non-associative integer
    operator whose result depends on the tree.
Served tokens are compared for equality.
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ParallelConfig as JaxParallel  # noqa: E402
from repro.configs.base import SSMConfig as JaxSSM  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.launch import serve as jax_serve_launch  # noqa: E402
from repro.launch import train as jax_train_launch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import (ParallelConfig, SSMConfig,  # noqa: E402
                                      get_config, reduced_config)
from repro_torch.data import loader  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import tree_leaves  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths,  # noqa: E402
                              tree_unflatten_like)

ARCH = "jamba-v0.1-52b"
RTOL, ATOL = 1e-5, 1e-6
BF16_RL2 = 1e-2
BF16_ULP = 2.0 ** -7
LOSS_RTOL, GRAD_RL2 = 1e-5, 1e-4
CHUNK = 8                         # the block tests' scan chunk
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
jconv = jax.jit(JM._causal_conv)
jforward = jax.jit(JM.mamba_forward, static_argnums=(2,),
                   static_argnames=("chunk",))
jdecode_block = jax.jit(JM.mamba_decode, static_argnums=(2,))
jinit = jax.jit(jlm.init_params, static_argnums=(1, 2))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jlm.decode_step, static_argnums=(3,))
jgrad = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                static_argnums=(2, 3))


def configs(n_layers: int = 8):
    """(JAX config, port config): reduced jamba, one super-block of 8
    layers, or ``n_layers`` = 16 for two."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    if n_layers != 8:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
    if dtype == "float32":
        err = float(np.abs(got - want).max())
        assert err <= RTOL * float(np.abs(want).max()) + ATOL, err
    else:
        rl2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rl2 <= BF16_RL2, rl2


def close_bf16_cache(got, want):
    """A bf16 K/V leaf within one bf16 ulp of each value plus the float32
    tolerance of the leaf."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    tol = BF16_ULP * np.abs(want) + RTOL * np.abs(want).max() + ATOL
    assert (np.abs(got - want) <= tol).all()


def close_cache(got: dict, want: dict):
    """Every cache leaf of a jamba stack: the same type as JAX's, the bf16
    K/V within `close_bf16_cache`, the Mamba states and the length within
    the float32 tolerance."""
    jleaves = dict(jax.tree_util.tree_leaves_with_path(want))
    paths = tree_flatten_with_paths(got)
    assert len(paths) == len(jleaves)
    for (path, leaf), (jpath, jleaf) in zip(paths, jleaves.items()):
        assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
        if path[-1] in ("k", "v"):
            close_bf16_cache(leaf, jleaf)
        else:
            assert_close(leaf, jleaf)


def shapes(tree):
    return lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       tree)


def jax_shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  tree)


# -- configs, layout and init ----------------------------------------------------

def test_config_and_param_counts_match_jax():
    """The config's fields equal JAX's, full and reduced; `param_count`
    (51,569,852,416) and `active_param_count` (12,109,840,384) equal
    JAX's; every layer's kind is JAX's (attention at 4 and 12 of 16, MoE at
    the odd layers); a stack with Mamba layers and no SSM config raises
    JAX's `ValueError` in the count."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         configs()[::-1], configs(16)[::-1]):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert [lm.layer_kind(ours, i) for i in range(ours.n_layers)] == [
            jlm.layer_kind(theirs, i) for i in range(theirs.n_layers)]
        assert lm.super_period(ours) == jlm.super_period(theirs) == 8
        assert lm.n_super(ours) == jlm.n_super(theirs)
    full = get_config(ARCH)
    assert (full.param_count(), full.active_param_count()) == (
        51_569_852_416, 12_109_840_384)
    assert {f.name for f in dataclasses.fields(SSMConfig)} == {
        f.name for f in dataclasses.fields(JaxSSM)}
    assert SSMConfig() == SSMConfig(**dataclasses.asdict(JaxSSM()))
    assert configs()[1].ssm == SSMConfig(d_state=8, d_conv=4, expand=2,
                                         dt_rank=16)
    unset = dataclasses.replace(full, ssm=None)
    with pytest.raises(ValueError, match="cfg.ssm is unset"):
        unset.param_count()
    with pytest.raises(ValueError, match="cfg.ssm is unset"):
        lm.check_family(unset)


def test_full_width_params_and_cache_have_the_jax_layout():
    """`lm.init_params` on ``meta`` at full width has JAX's tree, shapes
    and types (4 stacked super-blocks: Mamba blocks of d_inner 8,192 at
    the 7 non-attention places, MoE of 16 experts at the odd places); the
    cache has JAX's conv window, float32 SSM state and K/V at place 4."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    got = shapes(lm.init_params(0, cfg, device="meta"))
    want = jax_shapes(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    assert got == want
    ssm = got["blocks"]["pos0"]["ssm"]
    assert ssm["in_proj"] == ((4, 4096, 16384), "bfloat16")
    assert ssm["x_proj"] == ((4, 8192, 288), "bfloat16")
    assert ssm["a_log"] == ((4, 8192, 16), "float32")
    assert got["blocks"]["pos1"]["moe"]["experts"]["gate"] == (
        (4, 16, 4096, 14336), "bfloat16")
    assert "attn" in got["blocks"]["pos4"] and "ssm" not in got["blocks"][
        "pos4"]
    cache = shapes(lm.init_cache(cfg, 4, 1152, device="meta"))
    assert cache == jax_shapes(jax.eval_shape(
        lambda: jlm.init_cache(jcfg, 4, 1152)))
    assert cache["blocks"]["pos0"] == {
        "conv": ((4, 4, 3, 8192), "bfloat16"),
        "ssm": ((4, 4, 8192, 16), "float32")}
    assert cache["blocks"]["pos4"]["k"] == ((4, 4, 1152, 8, 128),
                                            "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_block_matches_jax(dtype):
    """`init_mamba_block`'s tree, shapes and types are JAX's; its constant
    leaves (``conv_b``, ``dt_bias``, ``a_log``, ``d_skip``) equal JAX's bit
    for bit; its matrices are `dense_init` draws (spread 1 / sqrt(fan-in));
    on ``meta`` (no generator) the same tree."""
    jcfg, cfg = configs()
    tdt, jdt = DTYPES[dtype]
    jp = JM.init_mamba_block(jax.random.PRNGKey(0), jcfg, jdt)
    gen = torch.Generator().manual_seed(0)
    p = M.init_mamba_block(gen, cfg, tdt)
    assert shapes(p) == jax_shapes(jp)
    assert shapes(M.init_mamba_block(None, cfg, tdt)) == jax_shapes(jp)
    want = carry(jp)
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        assert torch.equal(p[name], want[name]), name
    for name in ("in_proj", "x_proj", "out_proj"):
        w = p[name].float()
        assert float(w.std()) == pytest.approx(w.shape[0] ** -0.5, rel=0.1)


def test_init_params_draws_around_the_constant_leaves():
    """The port's model init from a seed: the same twice; in every stacked
    slot of every Mamba place the constant leaves are the block's
    constants, not draws; the matrices are drawn (non-zero, distinct
    across super-blocks)."""
    _, cfg = configs(16)
    a, b = (lm.init_params(3, cfg, dtype=torch.float32, device="cpu")
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    consts = M.init_mamba_block(None, cfg, torch.float32)
    ref = M.init_mamba_block(torch.Generator().manual_seed(0), cfg,
                             torch.float32)
    for j in range(8):
        blk = a["blocks"][f"pos{j}"]
        if j == 4:
            assert "ssm" not in blk
            continue
        ssm = blk["ssm"]
        for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
            assert ssm[name].shape == (2,) + consts[name].shape
            assert all(torch.equal(s, ref[name]) for s in ssm[name]), name
        w = ssm["in_proj"]
        assert float(w[0].abs().sum()) > 0 and not torch.equal(w[0], w[1])


# -- the block against JAX -------------------------------------------------------

def block_params(dtype: str, seed: int = 0):
    jcfg, _ = configs()
    jp = JM.init_mamba_block(jax.random.PRNGKey(seed), jcfg,
                             DTYPES[dtype][1])
    return jp, carry(jp)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    """`_causal_conv` of 2 rows of 11 steps over 256 channels, from zeros
    and from a carried bf16 state: the output and the new state (the last
    3 inputs)."""
    rng = np.random.default_rng(3)
    jx, x = both(rng.standard_normal((2, 11, 256)))
    jw, w = both(rng.standard_normal((4, 256)) * 0.5)
    jb, b = both(rng.standard_normal(256) * 0.1)
    if carried:
        js, s = both(rng.standard_normal((2, 3, 256)), "bfloat16")
        want, jstate = jconv(jx, jw, jb, js)
        got, state = M._causal_conv(x, w, b, s)
    else:
        want, jstate = jconv(jx, jw, jb)
        got, state = M._causal_conv(x, w, b)
    assert_close(got, want)
    assert torch.equal(state, carry(jstate))


def nonassoc(p, q):
    """A non-associative integer operator: its result depends on the
    combine tree."""
    return [2 * p[0] - q[0] + 1, p[1] * 3 - q[0]]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13, 128])
def test_associative_scan_follows_jax_tree(n):
    """`associative_scan` equals ``jax.lax.associative_scan`` bit for bit
    on a non-associative int32 operator (the same combine tree), along
    axis 1; from n = 4 on a sequential scan gives another result; and with the
    Mamba combine on float32 (log decay, input) pairs it is within the
    float32 tolerance."""
    rng = np.random.default_rng(n)
    a = rng.integers(-3, 4, (2, n, 3)).astype(np.int32)
    b = rng.integers(-3, 4, (2, n, 3)).astype(np.int32)
    want = jax.lax.associative_scan(
        lambda p, q: tuple(nonassoc(p, q)), (jnp.asarray(a), jnp.asarray(b)),
        axis=1)
    got = M.associative_scan(nonassoc, (torch.from_numpy(a),
                                        torch.from_numpy(b)), axis=1)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    seq = [torch.from_numpy(a[:, :1]), torch.from_numpy(b[:, :1])]
    outs = [seq]
    for t in range(1, n):
        seq = nonassoc(seq, [torch.from_numpy(a[:, t:t + 1]),
                             torch.from_numpy(b[:, t:t + 1])])
        outs.append(seq)
    sequential = torch.cat([o[0] for o in outs], dim=1)
    assert torch.equal(sequential, got[0]) == (n <= 3)

    la = -np.abs(rng.standard_normal((2, n, 5, 4))).astype(np.float32) * 0.3
    bx = rng.standard_normal((2, n, 5, 4)).astype(np.float32)

    def jcombine(p, q):
        return p[0] + q[0], jnp.exp(q[0]) * p[1] + q[1]
    jla, jb = jax.jit(lambda x, y: jax.lax.associative_scan(
        jcombine, (x, y), axis=1))(la, bx)
    tla, tb = M.associative_scan(M._combine, (torch.from_numpy(la),
                                              torch.from_numpy(bx)), axis=1)
    assert_close(tla, jla)
    assert_close(tb, jb)


def forward_inputs(rng, T: int, dtype: str, with_state: bool):
    jcfg, cfg = configs()
    d_in = cfg.ssm.expand * cfg.d_model
    jx, x = both(rng.standard_normal((2, T, cfg.d_model)), dtype)
    if not with_state:
        return jx, x, None, None
    jconv_s, conv_s = both(rng.standard_normal((2, 3, d_in)), dtype)
    jssm, ssm = both(rng.standard_normal((2, d_in, cfg.ssm.d_state)) * 0.5)
    return (jx, x, {"conv": jconv_s, "ssm": jssm},
            {"conv": conv_s, "ssm": ssm})


@pytest.mark.parametrize("T,with_state,dtype", [
    (5, False, "float32"), (8, False, "float32"), (37, False, "float32"),
    (5, True, "float32"), (37, True, "float32"), (37, True, "bfloat16")])
def test_mamba_forward_matches_jax(T, with_state, dtype):
    """`mamba_forward` with ``chunk`` = 8 at T < chunk, T = chunk and T =
    37 (four chunks carried, a pad of 3), from zeros and from a non-zero
    state: the output, the conv state and the float32 SSM state."""
    jcfg, cfg = configs()
    jp, p = block_params(dtype)
    rng = np.random.default_rng(T)
    jx, x, jst, st = forward_inputs(rng, T, dtype, with_state)
    want, jnew = jforward(jx, jp, jcfg, jst, chunk=CHUNK)
    got, new = M.mamba_forward(x, p, cfg, st, chunk=CHUNK)
    assert got.dtype == x.dtype and new["ssm"].dtype == torch.float32
    assert new["conv"].dtype == x.dtype
    assert_close(got, want, dtype)
    assert_close(new["conv"], jnew["conv"], dtype)
    assert_close(new["ssm"], jnew["ssm"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """Three `mamba_decode` steps of 3 lanes from a random state, each
    feeding the next: the output and both states; and (float32) a prefill
    of T tokens then one decode step equal to a prefill of T + 1 at its
    last position, the states included."""
    jcfg, cfg = configs()
    jp, p = block_params(dtype, seed=1)
    rng = np.random.default_rng(4)
    _, _, jst, st = forward_inputs(rng, 1, dtype, True)
    jst = {k: jnp.concatenate([v, v[:1]]) for k, v in jst.items()}
    st = {k: torch.cat([v, v[:1]]) for k, v in st.items()}
    for _ in range(3):
        jx, x = both(rng.standard_normal((3, 1, cfg.d_model)), dtype)
        want, jst = jdecode_block(jx, jp, jcfg, jst)
        got, st = M.mamba_decode(x, p, cfg, st)
        assert_close(got, want, dtype)
        assert_close(st["conv"], jst["conv"], dtype)
        assert_close(st["ssm"], jst["ssm"], dtype)
    if dtype != "float32":
        return
    x = torch.from_numpy(rng.standard_normal((2, 13, cfg.d_model)).astype(
        np.float32))
    _, pre = M.mamba_forward(x[:, :12], p, cfg, chunk=CHUNK)
    step, dec = M.mamba_decode(x[:, 12:], p, cfg, pre)
    full, whole = M.mamba_forward(x, p, cfg, chunk=CHUNK)
    assert_close(step[:, 0], full[:, 12].numpy())
    assert_close(dec["ssm"], whole["ssm"].numpy())
    assert torch.equal(dec["conv"], whole["conv"])


def test_softplus_is_jax_logaddexp():
    """`softplus` equals ``jax.nn.softplus`` within the float32 tolerance
    from -100 to 100, past `F.softplus`'s threshold of 20 included."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [0.0, 19.99, 20.0, 20.01, -1e-8]]).astype(np.float32)
    assert_close(M.softplus(torch.from_numpy(x)), jax.nn.softplus(x))


# -- the model against JAX -------------------------------------------------------

_MODEL: dict = {}


def model(n_layers: int = 8, dtype: str = "float32"):
    """JAX params (PRNGKey(0)) of reduced jamba of ``n_layers`` and the
    port's copy."""
    jcfg, cfg = configs(n_layers)
    key = (n_layers, dtype)
    if key not in _MODEL:
        jp = jinit(jax.random.PRNGKey(0), jcfg, DTYPES[dtype][1])
        _MODEL[key] = (jp, carry(jp))
    return jcfg, cfg, *_MODEL[key]


def tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def test_init_cache_matches_jax():
    """`lm.init_cache` of reduced jamba (3 lanes, max_len 16): JAX's tree,
    shapes and types, place by place (bf16 conv, float32 SSM state, bf16
    K/V at place 4), zero everywhere."""
    jcfg, cfg = configs()
    cache = lm.init_cache(cfg, 3, 16, device="cpu")
    assert shapes(cache) == jax_shapes(jlm.init_cache(jcfg, 3, 16))
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(cache))
    assert cache["blocks"]["pos0"]["conv"].data_ptr() != cache["blocks"][
        "pos1"]["conv"].data_ptr()


@pytest.mark.parametrize("n_layers", [8, 16])
def test_prefill_matches_jax(n_layers):
    """Logits and every cache leaf of a 37-token prefill (a pad of 91 to
    the chunk of 128): float32 params leave a float32 conv state, as in
    JAX; one super-block and two (``n_super`` = 2)."""
    jcfg, cfg, jp, p = model(n_layers)
    t = tokens(37, seed=n_layers)
    jlogits, jcache = jprefill(jp, {"tokens": jnp.asarray(t)}, jcfg, 48)
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg,
                                   48)
    assert_close(logits, jlogits)
    assert cache["len"].tolist() == [37]
    close_cache(cache, jcache)
    assert cache["blocks"]["pos0"]["conv"].dtype == torch.float32
    assert cache["blocks"]["pos0"]["ssm"].shape[0] == n_layers // 8


def test_bf16_prefill_is_as_close_to_float32_as_jax_bf16():
    """The super-block with bf16 weights: a bf16 rounding difference in a
    layer's input can flip a near tie of the router's top-2 and compounds
    over the 8 layers (JAX's own bf16 logits lie about 6e-2 relative L2
    from its float32 logits on the same weights), so the model is held to
    that: the port's bf16 prefill logits are no farther (relative L2) from
    JAX's float32 prefill on the same weights than JAX's bf16 prefill is.
    One layer in bf16 is held to 1e-2 by the block tests."""
    jcfg, cfg, jp, p = model(8, "bfloat16")
    t = tokens(37, seed=8)
    jlogits, _ = jprefill(jp, {"tokens": jnp.asarray(t)}, jcfg, 48)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    truth, _ = jprefill(jp32, {"tokens": jnp.asarray(t)}, jcfg, 48)
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg,
                                   48)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(
        logits).all())
    assert cache["blocks"]["pos0"]["conv"].dtype == torch.bfloat16
    assert rel_l2(logits, truth) <= rel_l2(torch.from_numpy(np.asarray(
        jlogits)), truth)


@pytest.mark.parametrize("n_layers", [8, 16])
def test_decode_step_matches_jax(n_layers):
    """Three decode steps of 4 lanes at lengths 3, 7, 1 and 11 from JAX's
    own random caches (bf16 conv, float32 SSM state, bf16 K/V), carried
    across: the logits and every cache leaf; the first step turns the conv
    window float32 (float32 params), as in JAX; the K/V is written in
    place."""
    jcfg, cfg, jp, p = model(n_layers)
    rng = np.random.default_rng(5)
    jcache = jlm.init_cache(jcfg, 4, 16)
    keys = iter(jax.random.split(jax.random.PRNGKey(9), 64))
    jcache = jax.tree_util.tree_map(
        lambda a: (jax.random.normal(next(keys), a.shape) * 0.3).astype(
            a.dtype) if a.ndim > 1 else a, jcache)
    jcache["len"] = jnp.asarray([3, 7, 1, 11], jnp.int32)
    cache = carry(jcache)
    k_leaf = cache["blocks"]["pos4"]["k"]
    for _ in range(3):
        t = rng.integers(0, 512, (4, 1))
        jlogits, jcache = jdecode(jp, jnp.asarray(t), jcache, jcfg)
        with torch.no_grad():
            logits, cache = lm.decode_step(p, torch.as_tensor(t), cache, cfg)
        assert_close(logits, jlogits)
        close_cache(cache, jcache)
    assert cache["blocks"]["pos4"]["k"] is k_leaf
    assert cache["blocks"]["pos0"]["conv"].dtype == torch.float32


def rel_l2(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


_JAX_GRADS: dict = {}


@pytest.mark.parametrize("n_layers,remat", [(8, "none"), (8, "block"),
                                            (16, "block")])
def test_loss_and_gradients_match_jax(n_layers, remat):
    """`lm.loss_fn`'s loss, ``ce`` and ``aux`` (the MoE layers'
    load-balance losses) and every gradient leaf, the Mamba blocks'
    constant leaves included, against `jax.value_and_grad` of JAX's (remat
    off there; the port's remat per super-block, over one super-block and
    over two, must not change them)."""
    jcfg, cfg, jp, p = model(n_layers)
    b = loader.lm_batch_fn(512, 2, 16, 0)(0, 0, 1)
    if n_layers not in _JAX_GRADS:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        _JAX_GRADS[n_layers] = jgrad(jp, jb, jcfg, JaxParallel(
            remat="none", fsdp=False, seq_parallel=False))
    (jloss, jaux), jgrads = _JAX_GRADS[n_layers]
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
    assert any("a_log" in path for path in paths)
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
    tokens each: both engines prefill a Mamba stack's prompts at their
    exact length (no buckets), and the compiled and the eager port engines
    serve JAX's tokens. The first (eager) tick turns the conv window
    float32 (float32 params), and the compiled ticks copy the new conv and
    SSM states into the cache's leaves in place."""
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
        assert eng.cache["blocks"]["pos0"]["conv"].dtype == torch.bfloat16
        got = drain(eng, [Request(rid=i, prompt=x, max_new_tokens=k)
                          for i, (x, k) in enumerate(zip(ps, news))])
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
        assert sorted(eng._prefill_cache) == [5, 11, 17]
        assert eng.cache["blocks"]["pos0"]["conv"].dtype == torch.float32
        assert eng.cache["blocks"]["pos0"]["ssm"].dtype == torch.float32
    assert eng.decode_ticks > 2
    assert isinstance(eng, EagerEngine)


def test_compiled_ticks_write_the_recurrent_state_in_place():
    """On the compiled engine, from tick 2 on, each tick writes the new
    conv window and SSM state into the cache leaves the graph holds (the
    same tensors every tick), and the state after the ticks equals the
    eager engine's."""
    _, cfg, _, p = model()
    prompt = np.arange(9) % 512
    engines = {}
    for cls in (ServeEngine, EagerEngine):
        eng = cls(p, cfg, batch_slots=2, max_len=32)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
        eng.step()                                  # admit, eager tick 1
        leaves = {k: eng.cache["blocks"]["pos0"][k] for k in ("conv", "ssm")}
        before = {k: v.clone() for k, v in leaves.items()}
        eng.step()
        eng.step()
        if cls is ServeEngine:
            assert eng._decode is not None
            for k, v in leaves.items():
                assert eng.cache["blocks"]["pos0"][k] is v
                assert not torch.equal(v, before[k])
        engines[cls] = eng
    for k in ("conv", "ssm"):
        assert torch.equal(engines[ServeEngine].cache["blocks"]["pos3"][k],
                           engines[EagerEngine].cache["blocks"]["pos3"][k])


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
    assert params["blocks"]["pos0"]["ssm"]["in_proj"].shape == (1, 128, 512)
    assert params["blocks"]["pos4"]["attn"]["wq"].shape == (1, 128, 128)
