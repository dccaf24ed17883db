"""The port's RWKV6 blocks and language model (repro_torch.models.rwkv, .lm)
against the JAX package's, on `reduced_config("rwkv6-7b")` (2 layers,
d_model 128, 4 heads of 32), with the JAX parameters carried across by
`lm.params_from_jax` and numpy-seeded inputs.

Tolerances:
  * float32: 2e-4 relative and absolute on every output, the JAX package's
    wkv6 tolerance; the two sides differ only in float32 summation order.
  * bfloat16: relative L2 error of the output against the JAX output at most
    1e-2 for one block and 5e-2 for the whole model (logits), and the
    largest elementwise error at most 2e-2 (block) or 8e-2 (model) of the
    largest JAX output magnitude. A bf16 rounding is up to 2^-9 (0.2 %)
    relative; XLA's CPU compiler keeps a fused chain of bf16 elementwise ops
    in float32 and rounds once, while torch rounds after every op, so the
    two differ by a few roundings in each block (about 0.3 % relative L2
    measured on these inputs) and these compound through the embedding, two
    blocks and the head (1 to 2.5 % measured).
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS  # noqa: E402
from repro.configs.base import ParallelConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_archs as jax_list_archs  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.configs.base import (ASSIGNED_ARCHS,  # noqa: E402
                                      MoEConfig, get_config, list_archs,
                                      reduced_config)
from repro_torch.models import layers, lm, rwkv  # noqa: E402

JCFG = jax_reduced(jax_get_config("rwkv6-7b"))
CFG = reduced_config(get_config("rwkv6-7b"))
PARALLEL = ParallelConfig(remat="none", scan_layers=True)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def close(got, want, dtype, level):
    """``got`` (torch) against ``want`` (JAX) at the module's tolerance for
    ``dtype`` and ``level`` ("block" or "model")."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    l2, peak = {"block": (1e-2, 2e-2), "model": (5e-2, 8e-2)}[level]
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max() / np.abs(want).max()
    assert err <= l2 and worst <= peak, (err, worst)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def block_params(dtype, seed=0):
    """One JAX block (time mix and channel mix) and the port's copy."""
    jp = jrwkv.init_rwkv_block(jax.random.PRNGKey(seed), JCFG, DTYPES[dtype][1])
    return jp, lm.params_from_jax(np_tree(jp), device="cpu")


def activations(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(DTYPES[dtype][0]),
            jnp.asarray(x, DTYPES[dtype][1]))


_MODELS = {}


def model(dtype):
    """JAX params of the reduced model from PRNGKey(3) and the port's copy."""
    if dtype not in _MODELS:
        jp = jlm.init_params(jax.random.PRNGKey(3), JCFG, dtype=DTYPES[dtype][1])
        _MODELS[dtype] = (jp, lm.params_from_jax(np_tree(jp), device="cpu"))
    return _MODELS[dtype]


def test_config_matches_jax():
    full = jax_get_config("rwkv6-7b")
    for ours, theirs in ((get_config("rwkv6-7b"), full), (CFG, JCFG)):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    assert list_archs() == jax_list_archs()
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS
    with pytest.raises(KeyError) as want:
        jax_get_config("whisper-large-v9")
    with pytest.raises(KeyError, match=re.escape(str(want.value)[1:-1])):
        get_config("whisper-large-v9")


def test_rms_norm_matches_jax():
    from repro.models.layers import rms_norm as jax_rms_norm
    x, jx = activations((3, 5, 128), "float32", 1)
    w = np.random.default_rng(2).standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(x, torch.from_numpy(w)).numpy(),
        np.asarray(jax_rms_norm(jx, jnp.asarray(w))), **F32_TOL)


def test_group_norm_uses_the_population_variance():
    y = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 128)).astype(np.float32))
    got = rwkv._group_norm(y, torch.ones(128), 4)
    want = jrwkv._group_norm(jnp.asarray(y.numpy()), jnp.ones(128), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    heads = got.reshape(2, 3, 4, 32)
    np.testing.assert_allclose(heads.var(-1, correction=0).numpy(), 1.0,
                               rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(dtype, with_state):
    jp, p = block_params(dtype)
    x, jx = activations((2, 12, 128), dtype, 5)
    state = jstate = None
    if with_state:
        rng = np.random.default_rng(6)
        shift = rng.standard_normal((2, 128)).astype(np.float32)
        wkv = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
        state = {"shift": torch.from_numpy(shift).to(x.dtype),
                 "wkv": torch.from_numpy(wkv)}
        jstate = {"shift": jnp.asarray(shift, jx.dtype),
                  "wkv": jnp.asarray(wkv)}
    out, st = rwkv.time_mix(x, p["tm"], CFG, state)
    jout, jst = jrwkv.time_mix(jx, jp["tm"], JCFG, jstate)
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    assert st["shift"].dtype == x.dtype and st["wkv"].dtype == torch.float32
    close(out, jout, dtype, "block")
    close(st["wkv"], jst["wkv"], dtype, "block")
    np.testing.assert_array_equal(st["shift"].float().numpy(),
                                  np.asarray(jst["shift"], np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_mix_decode_matches_jax(dtype):
    jp, p = block_params(dtype, seed=1)
    x, jx = activations((3, 1, 128), dtype, 7)
    rng = np.random.default_rng(8)
    shift = rng.standard_normal((3, 128)).astype(np.float32)
    wkv = rng.standard_normal((3, 4, 32, 32)).astype(np.float32)
    out, st = rwkv.time_mix_decode(
        x, p["tm"], CFG, {"shift": torch.from_numpy(shift),
                          "wkv": torch.from_numpy(wkv)})
    jout, jst = jrwkv.time_mix_decode(
        jx, jp["tm"], JCFG, {"shift": jnp.asarray(shift),
                             "wkv": jnp.asarray(wkv)})
    assert out.dtype == x.dtype and jout.dtype == jx.dtype
    close(out, jout, dtype, "block")
    close(st["wkv"], jst["wkv"], dtype, "block")


def test_time_mix_decode_equals_a_one_token_time_mix():
    _, p = block_params("float32", seed=2)
    x, _ = activations((2, 1, 128), "float32", 9)
    rng = np.random.default_rng(10)
    state = {"shift": torch.from_numpy(rng.standard_normal((2, 128)).astype(
                 np.float32)),
             "wkv": torch.from_numpy(rng.standard_normal(
                 (2, 4, 32, 32)).astype(np.float32))}
    out, st = rwkv.time_mix(x, p["tm"], CFG, state)
    out_d, st_d = rwkv.time_mix_decode(x, p["tm"], CFG, state)
    np.testing.assert_allclose(out_d.numpy(), out.numpy(), **F32_TOL)
    np.testing.assert_allclose(st_d["wkv"].numpy(), st["wkv"].numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(dtype, with_state):
    jp, p = block_params(dtype, seed=3)
    x, jx = activations((2, 7, 128), dtype, 11)
    last = np.random.default_rng(12).standard_normal((2, 128)).astype(
        np.float32)
    out, shift = rwkv.channel_mix(
        x, p["cm"], torch.from_numpy(last).to(x.dtype) if with_state else None)
    jout, jshift = jrwkv.channel_mix(
        jx, jp["cm"], jnp.asarray(last, jx.dtype) if with_state else None)
    assert out.dtype == x.dtype
    close(out, jout, dtype, "block")
    np.testing.assert_array_equal(shift.float().numpy(),
                                  np.asarray(jshift, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_jax(dtype):
    jp, p = model(dtype)
    toks = np.random.default_rng(1).integers(0, 512, (2, 9))
    logits, cache = lm.prefill(p, {"tokens": torch.from_numpy(toks)}, CFG, 16)
    jlogits, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                  JCFG, 16, PARALLEL)
    assert logits.dtype == torch.float32 and logits.shape == (2, 512)
    close(logits, jlogits, dtype, "model")
    assert torch.equal(cache["len"], torch.full((2,), 9, dtype=torch.int32))
    for key in ("shift_tm", "shift_cm", "wkv"):
        got = cache["blocks"]["pos0"][key]
        want = jcache["blocks"]["pos0"][key]
        assert got.shape == want.shape, key
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        close(got, want, dtype, "model")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_jax(dtype):
    """One decode step from the JAX prefill's cache (carried across), so the
    step alone is compared."""
    jp, p = model(dtype)
    toks = np.random.default_rng(2).integers(0, 512, (3, 6))
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            JCFG, 16, PARALLEL)
    cache = lm.params_from_jax(np_tree(jcache), device="cpu")
    nxt = np.array([[5], [7], [11]])
    logits, cache2 = lm.decode_step(p, torch.from_numpy(nxt), cache, CFG)
    jlogits, jcache2 = jlm.decode_step(jp, jnp.asarray(nxt, jnp.int32), jcache,
                                       JCFG, PARALLEL)
    close(logits, jlogits, dtype, "model")
    assert torch.equal(cache2["len"], torch.full((3,), 7, dtype=torch.int32))
    close(cache2["blocks"]["pos0"]["wkv"], jcache2["blocks"]["pos0"]["wkv"],
          dtype, "model")


def test_decode_matches_prefill():
    """Teacher forcing, as tests/test_arch_smoke.py holds the JAX model:
    prefill over t tokens equals prefill over t-1 then decode token t;
    float32 so the check tests the math, not bf16 rounding."""
    _, p = model("float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (1, 9)))
    full, _ = lm.prefill(p, {"tokens": toks}, CFG, 16)
    _, cache = lm.prefill(p, {"tokens": toks[:, :-1]}, CFG, 16)
    dec, _ = lm.decode_step(p, toks[:, -1:], cache, CFG)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_has_the_jax_layout(dtype):
    """Same nesting, shapes and types as the JAX init; drawn from the seed
    alone (the same seed gives the same weights)."""
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), JCFG,
                                                dtype=DTYPES[dtype][1]))
    p = lm.init_params(0, CFG, dtype=DTYPES[dtype][0], device="cpu")
    got = lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                      p)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jp)
    assert got == want
    again = lm.init_params(0, CFG, dtype=DTYPES[dtype][0], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(lm.tree_map(lambda a: a, p)),
        jax.tree_util.tree_leaves(again)))
    wo = p["blocks"]["pos0"]["rwkv"]["tm"]["wo"].float()
    assert abs(float(wo.std()) * 128 ** 0.5 - 1.0) < 0.05
    # the constant leaves equal JAX's
    jreal = jlm.init_params(jax.random.PRNGKey(0), JCFG, dtype=DTYPES[dtype][1])
    for path in (("final_norm",), ("blocks", "pos0", "norm1"),
                 ("blocks", "pos0", "rwkv", "tm", "decay_base"),
                 ("blocks", "pos0", "rwkv", "tm", "mu"),
                 ("blocks", "pos0", "rwkv", "tm", "gn_scale"),
                 ("blocks", "pos0", "rwkv", "cm", "mu_k")):
        got, want = p, jreal
        for key in path:
            got, want = got[key], want[key]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_draw_block_equals_init_block():
    """`lm._draw_block_` (a layer drawn into its stacked slot, as
    `init_params` does) makes the draws of a fresh `_init_block` from the
    same generator state: the RWKV leaves are drawn whole and copied."""
    fresh = lm._init_block(torch.Generator().manual_seed(2), CFG, 0,
                           torch.float32)
    slot = lm.tree_map(torch.empty_like, fresh)
    lm._draw_block_(torch.Generator().manual_seed(2), CFG, 0, torch.float32,
                    slot)
    lm.tree_map(lambda a, b: (torch.equal(a, b) or pytest.fail("differ")),
                slot, fresh)


def test_init_cache_has_the_jax_types():
    cache = lm.init_cache(CFG, 3, 32, device="cpu")
    jcache = jlm.init_cache(JCFG, 3, 32)
    got = lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                      cache)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jcache)
    assert got == want
    assert cache["blocks"]["pos0"]["shift_tm"].dtype == torch.bfloat16
    assert cache["blocks"]["pos0"]["wkv"].dtype == torch.float32


def test_other_families_are_not_ported():
    """The port runs every language model family of the JAX package; a MoE
    config with Mamba layers (jamba style, without the RWKV block) and no
    SSM config is refused with the JAX package's `ValueError`, a family the
    JAX package's lm does not model (the SNN family) by name, and an audio
    (encoder-decoder) config builds its cache with the encoder output."""
    moe = dataclasses.replace(
        CFG, arch_id="moe-like", family="moe", rwkv=None, attn_layer_period=2,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=64, every=2))
    with pytest.raises(ValueError, match="cfg.ssm is unset"):
        lm.init_params(0, moe, device="cpu")
    with pytest.raises(ValueError, match="cfg.ssm is unset"):
        lm.init_cache(moe, 1, 8, device="cpu")
    snn = dataclasses.replace(CFG, arch_id="snn-like", family="snn",
                              rwkv=None)
    with pytest.raises(NotImplementedError, match="'snn'"):
        lm.init_cache(snn, 1, 8, device="cpu")
    audio = dataclasses.replace(CFG, arch_id="audio-like", family="audio",
                                rwkv=None, is_encoder_decoder=True,
                                n_encoder_layers=2)
    assert lm.init_cache(audio, 1, 8, device="cpu", enc_len=5)[
        "enc_out"].shape == (1, 5, CFG.d_model)
