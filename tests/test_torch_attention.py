"""The port's attention-family layers (repro_torch.models.layers) and
spiking FFN (repro_torch.models.spiking_ffn) against the JAX package's, on
the same float32 inputs drawn from a numpy seed.

Tolerance (every comparison): |port - JAX| <= 1e-5 * max|JAX| + 1e-6
elementwise. XLA:CPU and torch sum float32 products in other orders and
round the 1/sqrt(D) scale and the RoPE angles' cos/sin by ulps, so the
outputs differ in the last bits, not more.
"""
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SpikingConfig as JaxSpiking  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import spiking_ffn as JS  # noqa: E402
from repro_torch.configs.base import SpikingConfig  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import spiking_ffn as S  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
JCFG = jax_reduced(jax_get_config("llama3.2-1b"))     # 4 heads, 2 KV heads
CFG = reduced_config(get_config("llama3.2-1b"))


def close(got, want):
    """The file's tolerance, relative to the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()) + ATOL, err


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a):
    """One numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a), torch.from_numpy(a.copy())


def attn_params(rng, cfg=JCFG):
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    arrs = {k: rand(rng, *s, scale=s[0] ** -0.5) for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrs.items()},
            {k: torch.from_numpy(a.copy()) for k, a in arrs.items()})


def test_reduced_config_is_gqa():
    assert (CFG.n_heads, CFG.n_kv_heads, CFG.head_dim) == (4, 2, 32)
    for f in dataclasses.fields(CFG):
        assert getattr(CFG, f.name) == getattr(JCFG, f.name), f.name


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norms_match_jax(norm):
    rng = np.random.default_rng(1)
    x, w, b = rand(rng, 3, 5, 64, scale=3.0), rand(rng, 64), rand(rng, 64)
    if norm == "rms":
        want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w))
        got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    else:
        want = JL.layer_norm(*map(jnp.asarray, (x, w, b)))
        got = L.layer_norm(*map(torch.from_numpy, (x, w, b)))
    close(got, want)


@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (64, 500000.0),
                                            (32, 10000.0)])
def test_apply_rope_matches_jax(head_dim, theta):
    """Positions 0 to 1,151 (phase 14's cache length)."""
    rng = np.random.default_rng(head_dim)
    x = rand(rng, 2, 1152, 3, head_dim)
    pos = np.stack([np.arange(1152), np.arange(1152)[::-1]])
    jx, tx = both(x)
    close(L.apply_rope(tx, torch.from_numpy(pos.copy()), theta),
          JL.apply_rope(jx, jnp.asarray(pos), theta))
    np.testing.assert_array_equal(L.rope_freqs(head_dim, theta).numpy(),
                                  np.asarray(JL.rope_freqs(head_dim, theta)))


@pytest.mark.parametrize("ffn_type", ["swiglu", "gelu"])
def test_ffn_matches_jax(ffn_type):
    rng = np.random.default_rng(2)
    jp = JL.init_ffn(jax.random.PRNGKey(0), 64, 96, ffn_type, jnp.float32)
    p = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = rand(rng, 2, 7, 64)
    jx, tx = both(x)
    close(L.ffn(tx, p, ffn_type), JL.ffn(jx, jp, ffn_type))


SDPA_CASES = {
    "causal": dict(causal=True),
    "causal_q_pos": dict(causal=True, q_pos=np.array([[5, 6, 7, 8],
                                                      [0, 1, 2, 3]])),
    "kv_len": dict(causal=False, kv_len=np.array([3, 9], np.int32)),
    "causal_q_pos_kv_len": dict(causal=True,
                                q_pos=np.array([[2, 3, 4, 5], [6, 7, 8, 9]]),
                                kv_len=np.array([6, 10], np.int32)),
}


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_matches_jax(case):
    kw = SDPA_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (rand(rng, 2, 4, 4, 16), rand(rng, 2, 12, 2, 16),
               rand(rng, 2, 12, 2, 16))
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    if "q_pos" not in kw and kw["causal"]:
        k, v = k[:, :4], v[:, :4]                  # self-attention, S == T
    jq, tq = both(q)
    jk, tk = both(k)
    jv, tv = both(v)
    close(L._sdpa(tq, tk, tv, **tkw), JL._sdpa(jq, jk, jv, **jkw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_block", [(4, 4), (8, 16), (16, 8)])
def test_blocked_attention_matches_jax(causal, q_chunk, kv_block):
    rng = np.random.default_rng(q_chunk * 31 + kv_block)
    q, k, v = (rand(rng, 2, 32, 4, 8), rand(rng, 2, 32, 2, 8),
               rand(rng, 2, 32, 2, 8))
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    got = L.blocked_attention(tq, tk, tv, causal=causal, q_chunk=q_chunk,
                              kv_block=kv_block)
    close(got, JL.blocked_attention(jq, jk, jv, causal=causal,
                                    q_chunk=q_chunk, kv_block=kv_block))
    close(got, JL._sdpa(jq, jk, jv, causal=causal,
                        q_pos=jnp.arange(32)[None]))


def test_blocked_attention_refuses_a_ragged_chunk():
    q = torch.zeros((1, 12, 2, 8))
    k = torch.zeros((1, 12, 2, 8))
    with pytest.raises(ValueError, match="T % q_chunk"):
        L.blocked_attention(q, k, k, causal=True, q_chunk=5, kv_block=4)
    with pytest.raises(ValueError, match="S % kv_block"):
        L.blocked_attention(q, k, k, causal=True, q_chunk=4, kv_block=5)


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_attention_matches_jax(q_chunk):
    rng = np.random.default_rng(4)
    jp, p = attn_params(rng)
    x = rand(rng, 2, 16, JCFG.d_model)
    pos = np.arange(16)[None]
    jx, tx = both(x)
    got = L.attention(tx, p, CFG, torch.from_numpy(pos.copy()),
                      q_chunk=q_chunk, kv_block=8)
    close(got, JL.attention(jx, jp, JCFG, jnp.asarray(pos), q_chunk=q_chunk,
                            kv_block=8))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_jax(cache_dtype):
    """Three lanes at positions 2, 9 and 5 write their K and V there, in
    place; every other slot of every lane keeps its value."""
    rng = np.random.default_rng(5)
    jp, p = attn_params(rng)
    B, S = 3, 12
    shape = (B, S, JCFG.n_kv_heads, JCFG.head_dim)
    kc, vc = rand(rng, *shape), rand(rng, *shape)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    jcache = {"k": jnp.asarray(kc, jdt), "v": jnp.asarray(vc, jdt)}
    cache = {"k": torch.from_numpy(kc.copy()).to(tdt),
             "v": torch.from_numpy(vc.copy()).to(tdt)}
    before = {n: t.clone() for n, t in cache.items()}
    pos = np.array([2, 9, 5], np.int32)
    x = rand(rng, B, 1, JCFG.d_model)
    jx, tx = both(x)
    want, jnew = JL.attention_decode(jx, jp, JCFG, jcache, jnp.asarray(pos))
    got, new = L.attention_decode(tx, p, CFG, cache, torch.from_numpy(pos))
    close(got, want)
    for n in ("k", "v"):
        assert new[n] is cache[n]
        close(new[n].float()[[0, 1, 2], pos],
              np.asarray(jnew[n], np.float32)[[0, 1, 2], pos])
        written = np.zeros((B, S), bool)
        written[[0, 1, 2], pos] = True
        assert torch.equal(new[n][torch.from_numpy(~written)],
                           before[n][torch.from_numpy(~written)])
        assert not torch.equal(new[n][0, 2], before[n][0, 2])


def test_attention_decode_drops_a_write_past_the_cache():
    """A lane at position S_max writes nothing (JAX drops the update)."""
    rng = np.random.default_rng(6)
    _, p = attn_params(rng)
    shape = (2, 4, CFG.n_kv_heads, CFG.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    x = torch.from_numpy(rand(rng, 2, 1, CFG.d_model))
    out, new = L.attention_decode(x, p, CFG, cache, torch.tensor([1, 4]))
    assert torch.isfinite(out).all()
    assert new["k"][1].abs().sum() == 0 and new["k"][0, 1].abs().sum() > 0


@pytest.mark.parametrize("neuron", ["rmp", "if", "lif"])
def test_spiking_ffn_matches_jax(neuron):
    jcfg = dataclasses.replace(JCFG, spiking=JaxSpiking(
        neuron=neuron, timesteps=8, threshold=0.5))
    cfg = dataclasses.replace(CFG, spiking=SpikingConfig(
        neuron=neuron, timesteps=8, threshold=0.5))
    jp = JS.init_spiking_ffn(jax.random.PRNGKey(1), jcfg.d_model, jcfg.d_ff,
                             dtype=jnp.float32)
    p = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = rand(np.random.default_rng(7), 2, 5, jcfg.d_model)
    jx, tx = both(x)
    want, jrate = JS.spiking_ffn(jx, jp, jcfg)
    got, rate = S.spiking_ffn(tx, p, cfg)
    close(got, want)
    assert 0.0 < float(rate) < 1.0
    assert abs(float(rate) - float(jrate)) <= RTOL * float(jrate) + ATOL


def test_attention_path_calls_no_library_attention():
    """The layers compute attention as plain products: no fused, flash or
    cuDNN attention call."""
    for mod in (L, lm, S):
        src = inspect.getsource(mod)
        for name in ("scaled_dot_product_attention", "flash_attn", "cudnn",
                     "sdp_kernel", "allow_tf32"):
            assert name not in src, (mod.__name__, name)
