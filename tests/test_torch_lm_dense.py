"""The port's dense attention family (repro_torch.models.lm, the spiking FFN
variant included) and its serving engine against the JAX package's.

Models: `reduced_config` of llama3.2-1b (tied embeddings, GQA with 2 KV
heads for 4 query heads), of starcoder2-15b (gelu FFN) and the llama3.2-1b
variant with the spiking FFN (RMP, 8 steps, threshold 0.5, as
`examples/spiking_ffn_lm.py`), float32 parameters drawn by JAX and carried
across by `lm.params_from_jax`. Tolerances: logits (float32) within
1e-5 * max|JAX| + 1e-6; the K/V cache is bf16 in both packages, and two
float32 values that differ by that tolerance can round to neighbouring
bf16 values, so each K/V value is held within one bf16 ulp of itself
(2^-7 relative) plus the float32 tolerance of its leaf. Served tokens are
compared for equality.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SpikingConfig as JaxSpiking  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs.base import (MoEConfig, SpikingConfig,  # noqa: E402
                                      SSMConfig)
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.engine import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7                 # relative, an upper bound
DENSE_ARCHS = ("llama3-8b", "llama3.2-1b", "phi3-medium-14b",
               "starcoder2-15b")
SPIKING = dict(neuron="rmp", timesteps=8, threshold=0.5)
# a MoE stack whose first layer is dense (deepseek's prelude, without MLA)
PRELUDE_MOE = MoEConfig(n_experts=4, top_k=1, d_ff=64, first_k_dense=1)
# a MoE stack with Mamba layers (jamba's interleave): refused without an
# SSM config, built with one
MAMBA_MOE = dict(attn_layer_period=2, moe=MoEConfig(n_experts=4, top_k=1,
                                                    d_ff=64, every=2))
MAMBA_SSM = SSMConfig(d_state=8, d_conv=4, expand=2, dt_rank=16)


def configs(name: str):
    """(JAX config, port config) of a test model."""
    arch = "starcoder2-15b" if name == "starcoder2" else "llama3.2-1b"
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced_config(
        get_config(arch))
    if name == "spiking":
        jcfg = dataclasses.replace(jcfg, spiking=JaxSpiking(**SPIKING))
        cfg = dataclasses.replace(cfg, spiking=SpikingConfig(**SPIKING))
    return jcfg, cfg


MODELS = ("llama3.2", "starcoder2", "spiking")
_PARAMS: dict = {}


def params(name: str):
    """JAX float32 params (PRNGKey(0)) of a test model and the port's copy."""
    if name not in _PARAMS:
        jcfg, _ = configs(name)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        _PARAMS[name] = (jp, lm.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return _PARAMS[name]


def close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()) + ATOL, err


def close_kv(got, want, n=None):
    """bf16 K/V within one bf16 ulp of each value plus the float32
    tolerance of the leaf, at positions below ``n`` along axis 2 (the
    cache's (layers, B, S, KV, D) layout)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if n is not None:
        got, want = got[:, :, :n], want[:, :, :n]
    tol = BF16_ULP * np.abs(want) + RTOL * np.abs(want).max() + ATOL
    assert (np.abs(got - want) <= tol).all()


def tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


# -- the parameter tree at full width ---------------------------------------

def shapes(tree):
    return lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       tree)


@pytest.mark.parametrize("arch", DENSE_ARCHS + ("llama3.2-1b+spiking",))
def test_full_width_params_have_the_jax_layout(arch):
    """init_params on ``meta`` (the same code that draws the weights)
    gives the JAX tree's keys, shapes and types at full width; the
    analytic count equals JAX's, which leaves out ``final_norm``."""
    base = arch.split("+")[0]
    jcfg, cfg = jax_get_config(base), get_config(base)
    if arch.endswith("spiking"):
        jcfg = dataclasses.replace(jcfg, spiking=JaxSpiking(**SPIKING))
        cfg = dataclasses.replace(cfg, spiking=SpikingConfig(**SPIKING))
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    p = lm.init_params(0, cfg, device="meta")
    assert shapes(p) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert cfg.param_count() == jcfg.param_count()
    numel = sum(a.numel() for a in tree_leaves(p))
    if cfg.spiking is None:
        assert numel == cfg.param_count() + cfg.d_model
    else:     # both count the spiking FFN as three swiglu matrices
        assert numel == (cfg.param_count() + cfg.d_model
                         - cfg.n_layers * cfg.d_model * cfg.d_ff)


def test_init_params_draws_the_same_weights_from_a_seed():
    _, cfg = configs("spiking")
    a, b = (lm.init_params(5, cfg, dtype=torch.float32, device="cpu")
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    wq = a["blocks"]["pos0"]["attn"]["wq"].float()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_init_params_draws_are_pinned():
    """The weights a seed draws stay what they were when each block was
    drawn whole and then copied into the stack: the init now draws each
    weight straight into its stacked slot (pinned sums of reduced
    llama3.2-1b, seed 5, bf16)."""
    _, cfg = configs("llama3.2")
    p = lm.init_params(5, cfg, dtype=torch.bfloat16, device="cpu")
    sums = [float(x.double().sum()) for x in (
        p["embed"], p["blocks"]["pos0"]["attn"]["wq"],
        p["blocks"]["pos0"]["ffn"]["down"])]
    assert sums == [-5.867088407278061, -21.64960753917694,
                    6.0444552302360535]
    assert sum(float(x.double().abs().sum())
               for x in tree_leaves(p)) == 21161.7265155809


@pytest.mark.parametrize("name", MODELS)
def test_draw_block_equals_init_block(name):
    """`lm._draw_block_`, which `init_params` uses to draw a layer straight
    into its stacked slot, makes the draws of a fresh `_init_block` from
    the same generator state."""
    _, cfg = configs(name)
    fresh = lm._init_block(torch.Generator().manual_seed(2), cfg, 0,
                           torch.bfloat16)
    slot = lm.tree_map(torch.empty_like, fresh)
    lm._draw_block_(torch.Generator().manual_seed(2), cfg, 0,
                    torch.bfloat16, slot)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(slot),
                                                 tree_leaves(fresh)))


def test_init_cache_has_the_jax_layout():
    jcfg, cfg = configs("llama3.2")
    assert shapes(lm.init_cache(cfg, 3, 24, device="cpu")) == \
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                               jlm.init_cache(jcfg, 3, 24))


# -- prefill and decode ------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_jax(name):
    jcfg, cfg = configs(name)
    jp, p = params(name)
    toks = tokens(11, seed=1)
    want, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    got, cache = lm.prefill(p, {"tokens": torch.from_numpy(toks)}, cfg, 24)
    close(got, want)
    assert cache["len"].tolist() == [11]
    for leaf in ("k", "v"):
        close_kv(cache["blocks"]["pos0"][leaf],
                 jcache["blocks"]["pos0"][leaf])


@pytest.mark.parametrize("name", MODELS)
def test_padded_prefill_matches_jax_and_the_exact_prefill(name):
    """11 tokens right-padded to 16 with their true length: JAX's padded
    prefill, and the port's exact-length one at the valid positions."""
    jcfg, cfg = configs(name)
    jp, p = params(name)
    toks = tokens(11, seed=2)
    padded = np.zeros((1, 16), np.int64)
    padded[:, :11] = toks
    want, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(padded)}, jcfg, 24,
                               length=jnp.int32(11))
    got, cache = lm.prefill(p, {"tokens": torch.from_numpy(padded)}, cfg, 24,
                            length=torch.tensor([11]))
    close(got, want)
    assert cache["len"].tolist() == [11]
    exact, ecache = lm.prefill(p, {"tokens": torch.from_numpy(toks)}, cfg, 24)
    close(got, exact.numpy())
    for leaf in ("k", "v"):
        close_kv(cache["blocks"]["pos0"][leaf],
                 jcache["blocks"]["pos0"][leaf])
        close_kv(cache["blocks"]["pos0"][leaf],
                 ecache["blocks"]["pos0"][leaf].float().numpy(), n=11)


@pytest.mark.parametrize("name", MODELS)
def test_decode_step_matches_jax(name):
    """Two lanes at lengths 9 and 5 (JAX's cache carried across), one
    decode step: the logits, and the K/V each lane wrote in place."""
    jcfg, cfg = configs(name)
    jp, p = params(name)
    jcache = jlm.init_cache(jcfg, 2, 16)
    for lane, n in enumerate((9, 5)):
        _, c1 = jlm.prefill(jp, {"tokens": jnp.asarray(tokens(n, seed=lane))},
                            jcfg, 16)
        jcache = jengine.lane_scatter(c1, jcache, jengine.probe_batch_axes(
            jcache, jlm.init_cache(jcfg, 3, 16)), lane)
    cache = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jcache),
                               device="cpu")
    k_before = cache["blocks"]["pos0"]["k"]
    nxt = np.array([[3], [77]])
    want, jcache2 = jlm.decode_step(jp, jnp.asarray(nxt), jcache, jcfg)
    got, cache2 = lm.decode_step(p, torch.from_numpy(nxt), cache, cfg)
    close(got, want)
    assert cache2["len"].tolist() == [10, 6]
    assert cache2["blocks"]["pos0"]["k"] is k_before
    for leaf in ("k", "v"):
        close_kv(cache2["blocks"]["pos0"][leaf],
                 jcache2["blocks"]["pos0"][leaf])


def test_prefill_plus_one_equals_prefill_then_decode():
    """Within the port: the bf16 K/V cache is all that parts them."""
    _, cfg = configs("llama3.2")
    _, p = params("llama3.2")
    toks = torch.from_numpy(tokens(12, seed=3))
    full, _ = lm.prefill(p, {"tokens": toks}, cfg, 16)
    _, cache = lm.prefill(p, {"tokens": toks[:, :-1]}, cfg, 16)
    dec, _ = lm.decode_step(p, toks[:, -1:], cache, cfg)
    err = float((dec - full).abs().max() / full.abs().max())
    assert err < 2e-2


def test_blocked_prefill_matches_the_plain_prefill():
    """ParallelConfig.attn_q_chunk selects blocked attention in prefill."""
    from repro_torch.configs.base import ParallelConfig
    _, cfg = configs("llama3.2")
    _, p = params("llama3.2")
    toks = {"tokens": torch.from_numpy(tokens(16, seed=4))}
    plain, _ = lm.prefill(p, toks, cfg, 16)
    blocked, _ = lm.prefill(p, toks, cfg, 16, ParallelConfig(
        attn_q_chunk=4, attn_kv_block=8))
    close(blocked, plain.numpy())


# -- the engine --------------------------------------------------------------

def prompts(n, seed=0, lo=4, hi=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi))) for _ in range(n)]


def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return sorted(eng.run_until_drained(), key=lambda r: r.rid)


class EagerEngine(ServeEngine):
    _compiled = False


@pytest.mark.parametrize("name", ["llama3.2", "spiking"])
def test_engine_matches_unmodified_jax_engine(name):
    """7 requests of 3 to 40 tokens through 3 slots, 6 new tokens each,
    with the JAX engine's bucketing on: the same tokens, the same buckets
    in the LRU; the compiled (static-buffer) port engine, the eager one
    and JAX's agree."""
    jcfg, cfg = configs(name)
    jp, p = params(name)
    ps = prompts(7, seed=5, lo=3, hi=41)
    jeng = JaxEngine(jp, jcfg, batch_slots=3, max_len=64)
    assert jeng._bucket_prompts
    want = drain(jeng, [JaxRequest(rid=i, prompt=x, max_new_tokens=6)
                        for i, x in enumerate(ps)])
    runs = {}
    for cls in (ServeEngine, EagerEngine):
        eng = cls(p, cfg, batch_slots=3, max_len=64)
        runs[cls] = (drain(eng, [Request(rid=i, prompt=x, max_new_tokens=6)
                                 for i, x in enumerate(ps)]), eng)
        assert list(eng._prefill_cache) == list(jeng._prefill_cache)
    assert sorted(jeng._prefill_cache) == sorted(
        {max(8, 1 << (len(x) - 1).bit_length()) for x in ps})
    for got, _ in runs.values():
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    compiled, eager = runs[ServeEngine][1], runs[EagerEngine][1]
    assert compiled._decode is not None and eager._decode is None
    assert all(isinstance(f, engine.graphed.StaticPrefill)
               for f in compiled._prefill_cache.values())
    for a, b in zip(tree_leaves(compiled.cache), tree_leaves(eager.cache)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_prefill_lru_evicts_as_the_jax_engine_does():
    """Bucket requests past PREFILL_CACHE_MAX, with hits between them: the
    same keys, in the same order, after every call."""
    jcfg, cfg = configs("llama3.2")
    jp, p = params("llama3.2")
    assert (engine.PREFILL_BUCKET_MIN, engine.PREFILL_CACHE_MAX) == (
        jengine.PREFILL_BUCKET_MIN, jengine.PREFILL_CACHE_MAX)
    jeng = JaxEngine(jp, jcfg, batch_slots=1, max_len=4096)
    eng = ServeEngine(p, cfg, batch_slots=1, max_len=4096)
    for plen in (3, 9, 17, 3, 40, 70, 130, 300, 600, 9, 1100, 2100, 4000,
                 17, 5):
        bucket = eng._prefill_bucket(plen)
        assert bucket == jeng._prefill_bucket(plen)
        eng._prefill_fn(bucket)
        jeng._prefill_fn(bucket)
        assert list(eng._prefill_cache) == list(jeng._prefill_cache)
    assert len(eng._prefill_cache) == engine.PREFILL_CACHE_MAX


def test_prompt_buckets_follow_the_jax_engine():
    jcfg, cfg = configs("llama3.2")
    jp, p = params("llama3.2")
    jeng = JaxEngine(jp, jcfg, batch_slots=1, max_len=100)
    eng = ServeEngine(p, cfg, batch_slots=1, max_len=100)
    for plen in range(1, 120):
        assert eng._prefill_bucket(plen) == jeng._prefill_bucket(plen)
    rwkv = reduced_config(get_config("rwkv6-7b"))
    reng = ServeEngine(lm.init_params(0, rwkv, dtype=torch.float32,
                                      device="cpu"), rwkv, max_len=64)
    assert not reng._bucket_prompts and reng._prefill_bucket(5) == 5


def test_spiking_programs_follow_the_call_shape(monkeypatch):
    """The spiking FFN builds its program for each call's (T, d_ff): the
    bucket's length in prefill, 1 in the (compiled) decode tick."""
    _, cfg = configs("spiking")
    _, p = params("spiking")
    seen = []
    build = pipeline.rate_coded_program

    def recording(sp, state_shape, device=None):
        seen.append(tuple(state_shape))
        return build(sp, state_shape, device=device)
    monkeypatch.setattr(pipeline, "rate_coded_program", recording)
    eng = ServeEngine(p, cfg, batch_slots=2, max_len=32)
    drain(eng, [Request(rid=0, prompt=np.arange(5), max_new_tokens=4)])
    n = cfg.n_layers
    assert seen == [(8, cfg.d_ff)] * n + [(1, cfg.d_ff)] * 3 * n
    assert eng._decode is not None


@pytest.mark.parametrize("family", ["moe", "hybrid", "audio", "vlm"])
def test_other_families_raise_by_name(family):
    """A MoE stack with Mamba layers (jamba style) and no SSM config is
    refused with the JAX package's `ValueError`; a hybrid stack with an
    SSM config builds, its Mamba layer's params and cache included; an
    encoder-decoder (audio) stack builds with its encoder, cross-attention
    and ``enc_out`` cache, and its engine prefills at the exact length; a
    vision-stub (vlm) stack builds as the dense one, its prefill counts
    the patches ahead of the tokens, and its engine buckets the (text)
    prompts. A family the JAX package's lm does not model is refused by
    name."""
    _, cfg = configs("llama3.2")
    kw = {"moe": MAMBA_MOE,
          "hybrid": dict(MAMBA_MOE, ssm=MAMBA_SSM),
          "audio": dict(is_encoder_decoder=True, n_encoder_layers=2,
                        frontend="audio_stub"),
          "vlm": dict(frontend="vision_stub")}[family]
    other = dataclasses.replace(cfg, arch_id=f"{family}-like", family=family,
                                **kw)
    if family == "moe":
        for make in (lambda: lm.init_params(0, other, device="cpu"),
                     lambda: lm.init_cache(other, 1, 8, device="cpu"),
                     lambda: ServeEngine(params("llama3.2")[1], other)):
            with pytest.raises(ValueError, match="cfg.ssm is unset"):
                make()
        unknown = dataclasses.replace(cfg, family="snn")
        with pytest.raises(NotImplementedError, match="'snn'"):
            lm.init_cache(unknown, 1, 8, device="cpu")
        return
    p = lm.init_params(0, other, device="cpu")
    cache = lm.init_cache(other, 1, 8, device="cpu", enc_len=3)
    eng = ServeEngine(p, other)
    if family == "hybrid":
        assert [lm.layer_kind(other, i) for i in range(2)] == [
            ("attn", "dense"), ("ssm", "moe")]
        assert set(p["blocks"]["pos1"]) == {"norm1", "ssm", "norm2", "moe"}
        assert set(cache["blocks"]["pos1"]) == {"conv", "ssm"}
        assert not eng._bucket_prompts
    elif family == "audio":
        assert set(p["blocks"]["pos0"]) == {"norm1", "attn", "cross",
                                            "norm_cross", "norm2", "ffn"}
        assert set(p["encoder"]) == {"blocks", "final_norm"}
        assert p["encoder"]["blocks"]["attn"]["wk"].shape == (2, 128, 128)
        assert cache["enc_out"].shape == (1, 3, 128)
        assert not eng._bucket_prompts
    else:
        assert set(p) == set(params("llama3.2")[1])
        assert set(cache) == {"blocks", "len"}
        patches = torch.zeros((1, 3, 128), dtype=torch.bfloat16)
        _, filled = lm.prefill(p, {"tokens": torch.arange(5)[None],
                                   "patches": patches}, other, 16)
        assert filled["len"].tolist() == [8]
        assert eng._bucket_prompts


def test_prelude_moe_runs_and_matches_jax():
    """A MoE stack whose first layer is dense (`PRELUDE_MOE` on the
    reduced llama3.2-1b: GQA, no MLA) runs: its params and cache carry
    ``prelude`` as JAX's do, prefill logits and K/V and two decode steps
    equal JAX's (float32 params)."""
    from repro.configs.base import MoEConfig as JaxMoE
    jcfg, cfg = configs("llama3.2")
    jcfg = dataclasses.replace(jcfg, family="moe", moe=JaxMoE(
        **dataclasses.asdict(PRELUDE_MOE)))
    cfg = dataclasses.replace(cfg, family="moe", moe=PRELUDE_MOE)
    assert lm.n_prelude(cfg) == jlm.n_prelude(jcfg) == 1
    jp = jax.jit(jlm.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    assert shapes(lm.init_params(0, cfg, torch.float32, device="meta")) == \
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert "ffn" in p["prelude"][0] and "moe" in p["blocks"]["pos0"]
    t = tokens(12, seed=4)
    jlogits, jcache = jax.jit(jlm.prefill, static_argnums=(2, 3))(
        jp, {"tokens": jnp.asarray(t)}, jcfg, 32)
    with torch.no_grad():
        logits, cache = lm.prefill(p, {"tokens": torch.as_tensor(t)}, cfg,
                                   32)
    close(logits, jlogits)
    close_kv(cache["prelude"][0]["k"][None], jcache["prelude"][0]["k"][None],
             n=12)
    close_kv(cache["blocks"]["pos0"]["v"], jcache["blocks"]["pos0"]["v"],
             n=12)
    jdecode = jax.jit(jlm.decode_step, static_argnums=(3,))
    for step in range(2):
        nxt = np.asarray(jlogits.argmax(-1))[:, None]
        jlogits, jcache = jdecode(jp, jnp.asarray(nxt), jcache, jcfg)
        with torch.no_grad():
            logits, cache = lm.decode_step(p, torch.as_tensor(nxt), cache,
                                           cfg)
        close(logits, jlogits)
    assert cache["len"].tolist() == [14]


def test_launcher_serves_the_dense_default_on_the_cpu(capsys):
    done = launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "4", "--slots", "2"])
    assert sorted(len(r.out_tokens) for r in done) == [4, 4, 4]
    assert "tok/s on cpu" in capsys.readouterr().out
    done = launch_serve.main(["--device", "cpu", "--requests", "2",
                              "--max-new", "3", "--arch", "starcoder2-15b"])
    assert sorted(len(r.out_tokens) for r in done) == [3, 3]
