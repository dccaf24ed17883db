"""The port's encoder-decoder family (whisper: the encoder, sinusoidal
positions, cross-attention, the ``enc_out`` cache) and vision-stub family
(llava: patch embeddings ahead of the text), `models.io_spec`, and the
configs, against the JAX package's, on the CPU.

Models: `reduced_config` of whisper-large-v3 (2 encoder and 2 decoder
layers of 128, 4 heads of 32, MHA, gelu FFN 256, vocab 512, tied
embeddings, no RoPE) and of llava-next-mistral-7b (2 layers of 128, 4
query and 2 KV heads of 32, SwiGLU 256, vocab 512). JAX draws the
parameters; `lm.params_from_jax` carries them across; inputs come from a
numpy seed. Most JAX oracles are `jax.jit`-ed; the decode step's is not
(below).

Tolerances:
  * float32: every output within 1e-5 * max|JAX| + 1e-6 elementwise; the
    bf16 K/V cache within one bf16 ulp of each value plus that tolerance;
    the loss within 1e-5 relative, every gradient leaf within 1e-4
    relative L2.
  * bfloat16 (a whisper prefill with bf16 weights): relative L2 of the
    logits and of ``enc_out`` at most 1e-2 (XLA keeps a fused bf16 chain
    in float32 and rounds once, torch rounds after every op).
  * bit for bit: `sinusoidal_positions` (both are float64 numpy rounded
    to float32), `io_spec`'s specs and `materialize`'s draws.
  * the decode step's positional term (`layers.sinusoidal_at`) within
    1.2e-7 absolute of the JAX package's float32 term, its angles equal.
    JAX's term is the op-by-op (eager) one: under `jax.jit` XLA:CPU
    rewrites 2i/d as i * 0.0015625 and fuses its own power, which moves
    the term by up to 1.2e-4 at positions up to 1,500, so the model's
    decode oracle runs eagerly.
Served tokens are compared for equality.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ASSIGNED_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallel  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.launch import serve as jax_serve_launch  # noqa: E402
from repro.models import io_spec as jio  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import (ASSIGNED_ARCHS,  # noqa: E402
                                      ParallelConfig, ShapeConfig,
                                      get_config, reduced_config)
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.models import io_spec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths,  # noqa: E402
                              tree_leaves, tree_unflatten_like)

WHISPER, LLAVA = "whisper-large-v3", "llava-next-mistral-7b"
ARCHS = (WHISPER, LLAVA)
RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7
BF16_RL2 = 1e-2
LOSS_RTOL, GRAD_RL2 = 1e-5, 1e-4
PE_ATOL = 1.2e-7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
jinit = jax.jit(jlm.init_params, static_argnums=(1, 2))
jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
jencoder = jax.jit(jlm._run_encoder, static_argnums=(2, 3))
jgrad = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                static_argnums=(2, 3))


def configs(arch: str):
    """(JAX config, port config), reduced."""
    return jax_reduced(jax_get_config(arch)), reduced_config(get_config(arch))


def carry(tree):
    return lm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")


def both(a, dtype: str = "float32"):
    """A numpy array as a JAX array of ``dtype`` and the port's copy."""
    ja = jnp.asarray(a, DTYPES[dtype][1])
    return ja, carry(ja)


def rel_l2(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def assert_close(got, want, dtype: str = "float32"):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    if dtype == "bfloat16":
        assert rel_l2(got, want) <= BF16_RL2
        return
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()) + ATOL, err


def close_cache(got: dict, want: dict, dtype: str = "float32"):
    """Every cache leaf: JAX's type; bf16 K/V within one bf16 ulp of each
    value plus the float32 tolerance (float32 weights); the rest within
    `assert_close`."""
    paths = tree_flatten_with_paths(got)
    jleaves = jax.tree_util.tree_leaves(want)
    assert len(paths) == len(jleaves)
    for (path, leaf), jleaf in zip(paths, jleaves):
        assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
        if path[-1] in ("k", "v") and dtype == "float32":
            g = leaf.detach().float().numpy()
            w = np.asarray(jleaf, np.float32)
            tol = BF16_ULP * np.abs(w) + RTOL * np.abs(w).max() + ATOL
            assert (np.abs(g - w) <= tol).all(), path
        elif leaf.dtype.is_floating_point:
            assert_close(leaf, jleaf, dtype)
        else:
            assert leaf.tolist() == np.asarray(jleaf).tolist(), path


def shapes(tree):
    return lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       tree)


def jax_shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  tree)


_MODELS: dict = {}


def model(arch: str, dtype: str = "float32"):
    """(JAX config, port config, JAX params from PRNGKey(0), the port's
    copy)."""
    jcfg, cfg = configs(arch)
    if (arch, dtype) not in _MODELS:
        jp = jinit(jax.random.PRNGKey(0), jcfg, DTYPES[dtype][1])
        _MODELS[arch, dtype] = (jp, carry(jp))
    return (jcfg, cfg, *_MODELS[arch, dtype])


def batch(arch: str, T: int, S: int, seed: int = 0, B: int = 2,
          targets: bool = False, dtype: str = "float32"):
    """(JAX batch, port batch): B rows of T tokens, with ``S`` stub frames
    (whisper) or patches (llava) of d 128 in ``dtype``."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 512, (B, T))
    jb = {"tokens": jnp.asarray(t, jnp.int32)}
    pb = {"tokens": torch.from_numpy(t)}
    if targets:
        y = rng.integers(0, 512, (B, T))
        jb["targets"], pb["targets"] = jnp.asarray(y, jnp.int32), \
            torch.from_numpy(y)
    key = "frames" if arch == WHISPER else "patches"
    jb[key], pb[key] = both(rng.standard_normal((B, S, 128)) * 0.5, dtype)
    return jb, pb


# -- configs and layouts -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_counts_match_jax(arch):
    """The config's fields equal JAX's, full and reduced (2 encoder layers
    for whisper); `param_count` and `active_param_count` equal JAX's
    (whisper 1,534,558,720 with its encoder and cross-attention, llava
    7,241,728,000)."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         configs(arch)[::-1]):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    full = get_config(arch)
    assert full.param_count() == {WHISPER: 1_534_558_720,
                                  LLAVA: 7_241_728_000}[arch]
    assert configs(arch)[1].n_encoder_layers == (2 if arch == WHISPER
                                                 else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_and_cache_have_the_jax_layout(arch):
    """`lm.init_params` and `lm.init_cache(enc_len=)` on ``meta`` at full
    width have JAX's trees, shapes and types (whisper: ``cross`` and
    ``norm_cross`` in every decoder block, ``encoder`` with 32 stacked
    MHA layers, ``enc_out`` in the cache). JAX's count leaves out the
    norms that are not a block's norm1 and norm2: ``final_norm``, and for
    whisper the encoder's ``final_norm`` and 32 ``norm_cross``, 34 x 1280
    = 43,520 parameters."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    p = lm.init_params(0, cfg, device="meta")
    assert shapes(p) == jax_shapes(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    enc_len = 1500 if arch == WHISPER else 0
    assert shapes(lm.init_cache(cfg, 4, 448, device="meta",
                                enc_len=enc_len)) == jax_shapes(
        jax.eval_shape(lambda: jlm.init_cache(jcfg, 4, 448,
                                              enc_len=enc_len)))
    numel = sum(a.numel() for a in tree_leaves(p))
    left_out = cfg.d_model * ((2 + cfg.n_layers) if arch == WHISPER else 1)
    assert numel == cfg.param_count() + left_out
    if arch == WHISPER:
        assert list(p["blocks"]["pos0"]) == ["norm1", "attn", "cross",
                                             "norm_cross", "norm2", "ffn"]
        assert list(p) == ["embed", "final_norm", "blocks", "encoder"]
        assert shapes(p["encoder"]["blocks"]["attn"]["wk"]) == (
            (32, 1280, 1280), "bfloat16")


def test_init_draws_cross_attention_and_encoder_norms():
    """The port's draws from a seed (reduced whisper, float32): the same
    twice; every ``norm_cross`` and encoder norm is ones, not a draw; the
    cross-attention and encoder weights are `dense_init` draws (spread 1 /
    sqrt(fan-in)), distinct across stacked layers; `_draw_block_` into a
    slot equals a fresh `_init_block` (and, for an encoder layer,
    `_init_encoder_block`) from the same generator state."""
    _, cfg = configs(WHISPER)
    a, b = (lm.init_params(3, cfg, dtype=torch.float32, device="cpu")
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    enc = a["encoder"]
    for norm in (a["blocks"]["pos0"]["norm_cross"], enc["blocks"]["norm1"],
                 enc["blocks"]["norm2"], enc["final_norm"]):
        assert bool((norm == 1).all())
    for w in (a["blocks"]["pos0"]["cross"]["wk"], enc["blocks"]["attn"]["wq"],
              enc["blocks"]["ffn"]["down"]):
        assert float(w.std()) == pytest.approx(w.shape[1] ** -0.5, rel=0.1)
        assert not torch.equal(w[0], w[1])
    for idx, init in ((0, lambda g: lm._init_block(g, cfg, 0, torch.bfloat16)),
                      (None, lambda g: lm._init_encoder_block(
                          g, cfg, torch.bfloat16))):
        fresh = init(torch.Generator().manual_seed(2))
        slot = lm.tree_map(torch.empty_like, fresh)
        lm._draw_block_(torch.Generator().manual_seed(2), cfg, idx,
                        torch.bfloat16, slot)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(slot),
                                                     tree_leaves(fresh)))


# -- io_spec ---------------------------------------------------------------------

SPEC_CASES = [(arch, kind) for arch in (WHISPER, LLAVA, "llama3.2-1b")
              for kind in ("train", "prefill", "decode")]


def specs(arch: str, kind: str, seq: int = 64, B: int = 2):
    """(JAX spec, port spec) of ``kind`` for the reduced config."""
    jcfg, cfg = configs(arch)
    fn = {"train": "train_batch_spec", "prefill": "prefill_batch_spec",
          "decode": "decode_spec"}[kind]
    return (getattr(jio, fn)(jcfg, JaxShape("s", seq, B, kind)),
            getattr(io_spec, fn)(cfg, ShapeConfig("s", seq, B, kind)))


@pytest.mark.parametrize("arch,kind", SPEC_CASES)
def test_specs_match_jax(arch, kind):
    """Train, prefill and decode specs: JAX's tree, shapes and types, as
    ``meta`` tensors (whisper: 64 frames and 8 decoder tokens in prefill,
    a 64-frame ``enc_out`` in decode; llava: 16 patches and 48 tokens)."""
    jspec, spec = specs(arch, kind)
    assert all(t.device.type == "meta" for t in tree_leaves(spec))
    assert shapes(spec) == jax_shapes(jspec)
    if arch == WHISPER and kind == "prefill":
        assert shapes(spec) == {"frames": ((2, 64, 128), "bfloat16"),
                                "tokens": ((2, 8), "int32")}
    if arch == LLAVA and kind == "train":
        assert spec["patches"].shape == (2, 16, 128)
        assert spec["targets"].shape == (2, 48)


@pytest.mark.parametrize("arch,kind", SPEC_CASES)
def test_materialize_matches_jax_bit_for_bit(arch, kind):
    """`materialize` from seed 7 equals JAX's draws bit for bit, leaf for
    leaf in JAX's (sorted-key) order, each of JAX's type; the dict keeps
    its own key order."""
    jspec, spec = specs(arch, kind)
    got = io_spec.materialize(spec, 7, device="cpu")
    want = jio.materialize(jspec, 7)
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert g.device.type == "cpu"
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
    if kind != "decode":
        assert list(got) == list(spec)


def test_materialize_draws_in_sorted_key_order():
    """A whisper train batch is {frames, tokens, targets}, drawn frames,
    targets, tokens: the second integer draw is ``targets``, as in JAX."""
    _, spec = specs(WHISPER, "train", seq=16)
    got = io_spec.materialize(spec, 0, device="cpu")
    rng = np.random.default_rng(0)
    rng.standard_normal((2, 16, 128))
    first, second = (rng.integers(0, 64, (2, 16)) for _ in range(2))
    assert list(got) == ["frames", "tokens", "targets"]
    assert np.array_equal(got["targets"].numpy(), first)
    assert np.array_equal(got["tokens"].numpy(), second)


# -- layers ----------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1, 128), (37, 128), (1500, 1280)])
def test_sinusoidal_positions_bit_for_bit(seq, d):
    got = L.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    assert np.array_equal(got.numpy(),
                          np.asarray(JL.sinusoidal_positions(seq, d)))


def jax_decode_term(pos, d: int):
    """The JAX package's decode positional term, op by op
    (`repro/models/lm.py`, `decode_step`)."""
    i = jnp.arange(d // 2, dtype=jnp.float32)
    ang = pos[:, None].astype(jnp.float32) / jnp.power(10000.0, 2 * i / d)
    return ang, jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


@pytest.mark.parametrize("d", [128, 1280])
def test_decode_positional_term_matches_jax(d):
    """`sinusoidal_at` at every position up to 1,500: the angles equal
    JAX's bit for bit, the term within 1.2e-7 absolute (float32 sin and
    cos, an ulp apart on some inputs); `torch.pow` in float32 would not
    give JAX's divisors at d = 1280."""
    pos = np.arange(1501)
    jang, want = jax_decode_term(jnp.asarray(pos, jnp.int32), d)
    got = L.sinusoidal_at(torch.from_numpy(pos).int(), d)
    assert got.dtype == torch.float32 and got.shape == (1501, d)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= PE_ATOL
    i = torch.arange(d // 2, dtype=torch.float32)
    div = torch.pow(10000.0, (2 * i / d).double()).float()
    ang = torch.from_numpy(pos).float()[:, None] / div
    assert np.array_equal(ang.numpy(), np.asarray(jang))
    jdiv = np.asarray(jnp.power(10000.0, 2 * jnp.arange(
        d // 2, dtype=jnp.float32) / d))
    assert np.array_equal(div.numpy(), jdiv)
    if d == 1280:
        assert not np.array_equal(torch.pow(10000.0, 2 * i / d).numpy(),
                                  jdiv)


def test_cross_attention_init_is_mha():
    """`init_attention(cross=True)` gives every query head its own K/V head
    (llava's GQA config: 4 query heads, 2 KV heads otherwise)."""
    _, cfg = configs(LLAVA)
    gqa = L.init_attention(None, cfg)
    mha = L.init_attention(None, cfg, cross=True)
    assert gqa["wk"].shape == (128, 64) and mha["wk"].shape == (128, 128)
    assert mha["wq"].shape == mha["wv"].shape == mha["wo"].T.shape


@pytest.mark.parametrize("dtype,q_chunk", [("float32", 0), ("float32", 4),
                                           ("bfloat16", 0)])
def test_attention_kv_x_matches_jax(dtype, q_chunk):
    """`attention(kv_x=)`: 8 queries attend 12 encoder positions, no RoPE
    and no causal mask whatever ``causal`` says, plain and blocked (q chunk
    4, kv block 4), on reduced llava's GQA weights (RoPE theta 1e6, which
    kv_x must switch off)."""
    jcfg, cfg = configs(LLAVA)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg, dtype=DTYPES[dtype][1])
    p = carry(jp)
    rng = np.random.default_rng(2)
    jx, x = both(rng.standard_normal((2, 8, 128)), dtype)
    jsrc, src = both(rng.standard_normal((2, 12, 128)), dtype)
    pos = np.arange(8)[None]
    want = JL.attention(jx, jp, jcfg, jnp.asarray(pos), causal=True,
                        kv_x=jsrc, q_chunk=q_chunk, kv_block=4)
    got = L.attention(x, p, cfg, torch.from_numpy(pos), causal=True,
                      kv_x=src, q_chunk=q_chunk, kv_block=4)
    assert got.dtype == x.dtype
    assert_close(got, want, dtype)
    self_attn = L.attention(x, p, cfg, torch.from_numpy(pos))
    assert rel_l2(self_attn, np.asarray(want, np.float32)) > 0.1


def test_attention_decode_cross_kv_matches_jax():
    """`attention_decode(cross_kv=)`: 3 lanes' one-token queries against
    a fixed (k, v) of 10 positions; the cache comes back untouched."""
    jcfg, cfg = configs(WHISPER)
    jp = JL.init_attention(jax.random.PRNGKey(4), jcfg, cross=True,
                           dtype=jnp.float32)
    p = carry(jp)
    rng = np.random.default_rng(5)
    jx, x = both(rng.standard_normal((3, 1, 128)))
    jk, k = both(rng.standard_normal((3, 10, 4, 32)))
    jv, v = both(rng.standard_normal((3, 10, 4, 32)))
    cache = {"k": torch.zeros(3, 4, 4, 32), "v": torch.zeros(3, 4, 4, 32)}
    jcache = {"k": jnp.zeros((3, 4, 4, 32)), "v": jnp.zeros((3, 4, 4, 32))}
    pos = np.asarray([0, 2, 3], np.int32)
    want, _ = JL.attention_decode(jx, jp, jcfg, jcache, jnp.asarray(pos),
                                  cross_kv=(jk, jv))
    got, out_cache = L.attention_decode(x, p, cfg, cache,
                                        torch.from_numpy(pos),
                                        cross_kv=(k, v))
    assert out_cache is cache
    assert float(cache["k"].abs().sum()) == 0
    assert_close(got, want)


@pytest.mark.parametrize("dtype,q_chunk", [("float32", 0), ("float32", 8),
                                           ("bfloat16", 0)])
def test_run_encoder_matches_jax(dtype, q_chunk):
    """`_run_encoder` over 16 frames (2 layers, the blocked form at q chunk
    8 too): the output after the encoder's final norm."""
    jcfg, cfg, jp, p = model(WHISPER, dtype)
    _, pb = batch(WHISPER, 4, 16, seed=3, dtype=dtype)
    jf = jnp.asarray(pb["frames"].float().numpy(), DTYPES[dtype][1])
    want = jencoder(jp, jf, jcfg, JaxParallel(attn_q_chunk=q_chunk,
                                              attn_kv_block=8))
    got = lm._run_encoder(p, pb["frames"], cfg,
                          ParallelConfig(attn_q_chunk=q_chunk,
                                         attn_kv_block=8))
    assert got.dtype == DTYPES[dtype][0]
    assert_close(got, want, dtype)


# -- the models ------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(WHISPER, "float32"),
                                        (WHISPER, "bfloat16"),
                                        (LLAVA, "float32")])
def test_prefill_matches_jax(arch, dtype):
    """Logits and every cache leaf of a prefill: whisper over 16 frames and
    9 decoder tokens (``enc_out`` the encoder's output), llava with 6
    patches ahead of 9 tokens (``cache["len"]`` = 15)."""
    jcfg, cfg, jp, p = model(arch, dtype)
    jb, pb = batch(arch, 9, 16 if arch == WHISPER else 6, seed=1,
                   dtype=dtype)
    want, jcache = jprefill(jp, jb, jcfg, 24)
    with torch.no_grad():
        got, cache = lm.prefill(p, pb, cfg, 24)
    assert_close(got, want, dtype)
    close_cache(cache, jcache, dtype)
    assert cache["len"].tolist() == ([9, 9] if arch == WHISPER
                                     else [15, 15])
    if arch == WHISPER:
        assert torch.equal(cache["enc_out"],
                           lm._run_encoder(p, pb["frames"], cfg))


def test_llava_prefill_length_counts_the_patches():
    """A llava prompt right-padded to 12 tokens behind 6 patches, with
    ``length`` = 6 + 7: the logits at position 12 and ``cache["len"]``
    equal JAX's, and equal the unpadded prefill's."""
    jcfg, cfg, jp, p = model(LLAVA)
    jb, pb = batch(LLAVA, 12, 6, seed=4)
    want, jcache = jax.jit(lambda pp, b: jlm.prefill(pp, b, jcfg, 24,
                                                     length=13))(jp, jb)
    got, cache = lm.prefill(p, pb, cfg, 24, length=13)
    assert_close(got, want)
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist() == \
        [13, 13]
    exact, _ = lm.prefill(p, {"patches": pb["patches"],
                              "tokens": pb["tokens"][:, :7]}, cfg, 24)
    assert_close(got, exact.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Three decode steps after a prefill, each step's argmax fed to the
    next: the logits and every cache leaf (whisper: the positional term
    at each lane's length, cross-attention over ``enc_out``; llava:
    positions after the patches). The JAX step runs op by op (its
    positional term, see the module's docstring); the K/V is written in
    place."""
    jcfg, cfg, jp, p = model(arch)
    jb, pb = batch(arch, 9, 16 if arch == WHISPER else 6, seed=2)
    _, jcache = jprefill(jp, jb, jcfg, 24)
    with torch.no_grad():
        _, cache = lm.prefill(p, pb, cfg, 24)
    k_leaf = cache["blocks"]["pos0"]["k"]
    rng = np.random.default_rng(6)
    for _ in range(3):
        t = rng.integers(0, 512, (2, 1))
        want, jcache = jlm.decode_step(jp, jnp.asarray(t, jnp.int32), jcache,
                                       jcfg)
        with torch.no_grad():
            got, cache = lm.decode_step(p, torch.from_numpy(t), cache, cfg)
        assert_close(got, want)
        close_cache(cache, jcache)
    assert cache["blocks"]["pos0"]["k"] is k_leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_prefill_of_one_more(arch):
    """Float32 weights: a prefill of 9 tokens then a decode step of the
    10th gives the logits of a prefill of all 10 within JAX's own tolerance
    for this check (`test_arch_smoke.test_decode_matches_prefill_dense`:
    2e-2 relative + 2e-2 absolute elementwise), since the decode step
    reads the bf16 K/V cache where the prefill used float32 K and V."""
    _, cfg, _, p = model(arch)
    _, pb = batch(arch, 10, 16 if arch == WHISPER else 6, seed=8)
    with torch.no_grad():
        full, _ = lm.prefill(p, pb, cfg, 24)
        _, cache = lm.prefill(p, dict(pb, tokens=pb["tokens"][:, :9]), cfg,
                              24)
        dec, _ = lm.decode_step(p, pb["tokens"][:, 9:], cache, cfg)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch,remat", [(WHISPER, "none"), (WHISPER, "block"),
                                        (LLAVA, "none"), (LLAVA, "block")])
def test_loss_and_gradients_match_jax(arch, remat):
    """`lm.loss_fn`'s loss and ``ce`` and every gradient leaf (the encoder
    and cross-attention weights among them; llava scores the 8 text
    positions after 4 patches) against `jax.value_and_grad` of JAX's loss
    with the same remat setting (per super-block and per encoder layer)."""
    jcfg, cfg, jp, p = model(arch)
    jb, pb = batch(arch, 8, 12 if arch == WHISPER else 4, seed=5,
                   targets=True)
    (jloss, jaux), jgrads = jgrad(jp, jb, jcfg, JaxParallel(
        remat=remat, fsdp=False, seq_parallel=False))
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    loss, aux = lm.loss_fn(tree_unflatten_like(p, leaves), pb, cfg,
                           ParallelConfig(remat=remat))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(aux["ce"].detach()) == pytest.approx(float(jaux["ce"]),
                                                      rel=LOSS_RTOL)
    paths = [path for path, _ in tree_flatten_with_paths(p)]
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    if arch == WHISPER:
        assert ("encoder", "blocks", "attn", "wq") in paths
    bad = {"/".join(map(str, path)): rel_l2(g, jg)
           for path, g, jg in zip(paths, grads, jleaves)
           if not rel_l2(g, jg) <= GRAD_RL2}
    assert not bad, bad


def test_encoder_remat_recomputes_each_layer(monkeypatch):
    """With remat each encoder layer's attention runs twice in a train
    step (forward, then again in the backward pass), without it once; a
    prefill (no grad) never recomputes."""
    _, cfg, _, p = model(WHISPER)
    _, pb = batch(WHISPER, 8, 12, seed=5, targets=True)
    calls = []
    orig = L.attention

    def counting(x, *args, **kw):
        if kw.get("use_rope") is False:
            calls.append(1)
        return orig(x, *args, **kw)
    monkeypatch.setattr(L, "attention", counting)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    for remat, want in (("none", 2), ("block", 4)):
        calls.clear()
        loss, _ = lm.loss_fn(tree_unflatten_like(p, leaves), pb, cfg,
                             ParallelConfig(remat=remat))
        torch.autograd.grad(loss, leaves)
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        lm.prefill(p, pb, cfg, 24)
    assert len(calls) == 2


# -- serving ---------------------------------------------------------------------

class EagerEngine(ServeEngine):
    _compiled = False


def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return sorted(eng.run_until_drained(), key=lambda r: r.rid)


def test_llava_engine_matches_unmodified_jax_engine():
    """Reduced llava served text-only (no patches, as the JAX engine serves
    it): 6 requests of 4 to 16 tokens, 3 to 6 new tokens each, through 3
    slots; both engines bucket the prompts, and the compiled and the eager
    port engines serve JAX's tokens."""
    jcfg, cfg, jp, p = model(LLAVA)
    rng = np.random.default_rng(9)
    ps = [rng.integers(0, 512, int(rng.integers(4, 17))) for _ in range(6)]
    news = [int(rng.integers(3, 7)) for _ in ps]
    jeng = JaxEngine(jp, jcfg, batch_slots=3, max_len=40)
    assert jeng._bucket_prompts
    want = drain(jeng, [JaxRequest(rid=i, prompt=x, max_new_tokens=k)
                        for i, (x, k) in enumerate(zip(ps, news))])
    for cls in (ServeEngine, EagerEngine):
        eng = cls(p, cfg, batch_slots=3, max_len=40)
        assert eng._bucket_prompts and eng._prefill_bucket(9) == 16
        got = drain(eng, [Request(rid=i, prompt=x, max_new_tokens=k)
                          for i, (x, k) in enumerate(zip(ps, news))])
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert eng.decode_ticks > 2


def test_whisper_engine_raises_for_the_missing_frames():
    """Neither engine can serve whisper: its prefill passes only
    ``tokens``, and both raise `KeyError: 'frames'` at the first
    admission; neither buckets an encoder-decoder's prompts; the serve
    launchers fail the same way."""
    jcfg, cfg, jp, p = model(WHISPER)
    jeng = JaxEngine(jp, jcfg, batch_slots=2, max_len=24)
    eng = ServeEngine(p, cfg, batch_slots=2, max_len=24)
    assert not jeng._bucket_prompts and not eng._bucket_prompts
    assert eng.cache["enc_out"].shape == (2, 0, 128)
    jeng.submit(JaxRequest(rid=0, prompt=np.arange(5), max_new_tokens=3))
    eng.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=3))
    for e in (jeng, eng):
        with pytest.raises(KeyError, match="'frames'"):
            e.run_until_drained()
    with pytest.raises(KeyError, match="'frames'"):
        jax_serve_launch.main(["--arch", WHISPER, "--requests", "1"])
    with pytest.raises(KeyError, match="'frames'"):
        serve_launch.main(["--arch", WHISPER, "--requests", "1",
                           "--device", "cpu"])


# -- every assigned architecture -------------------------------------------------

SMOKE = dict(seq_len=32, global_batch=2)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_assigned_arch_runs_reduced(arch):
    """As the JAX package's `test_arch_smoke`, on the port: the reduced
    config of each of the ten assigned architectures (the same list as
    JAX's), bf16 weights from a seed and `io_spec` batches: the loss is
    finite and positive and its gradients finite and not all zero;
    prefill, then one decode step, give finite (B, vocab) logits and a
    length of the prompt (patches included) plus one."""
    assert ASSIGNED_ARCHS == JAX_ARCHS
    cfg = reduced_config(get_config(arch))
    params = lm.init_params(0, cfg, device="cpu")
    b = io_spec.materialize(io_spec.train_batch_spec(
        cfg, ShapeConfig("smoke", kind="train", **SMOKE)), device="cpu")
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = lm.loss_fn(tree_unflatten_like(params, leaves), b, cfg,
                         ParallelConfig(remat="block"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert bool(torch.isfinite(loss)) and float(loss.detach()) > 0
    total = sum(float(g.float().abs().sum()) for g in grads if g is not None)
    assert np.isfinite(total) and total > 0
    pb = io_spec.materialize(io_spec.prefill_batch_spec(
        cfg, ShapeConfig("smoke", kind="prefill", **SMOKE)), seed=1,
        device="cpu")
    with torch.no_grad():
        logits, cache = lm.prefill(params, pb, cfg, 48)
        nxt = logits.argmax(-1)[:, None]
        logits2, cache = lm.decode_step(params, nxt, cache, cfg)
    for lg in (logits, logits2):
        assert lg.shape == (2, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all())
    n = pb["tokens"].shape[1] + (pb["patches"].shape[1] if "patches" in pb
                                 else 0)
    assert cache["len"].tolist() == [n + 1] * 2
