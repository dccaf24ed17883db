"""The port's language-model serving engine (repro_torch.serve.ServeEngine)
against the JAX package's `ServeEngine`, on `reduced_config("rwkv6-7b")` in
float32 with the JAX parameters carried across by `lm.params_from_jax`:
every request's generated tokens are compared for equality (argmax of
logits that agree within float32 summation order).

The JAX engine pads RWKV prompts to power-of-two buckets: its
``_bucket_prompts`` test asks ``cfg.is_attention_layer(i)``, which is true
for every layer of a config with ``attn_layer_period`` 1, rwkv6-7b's
included, although its own comments and `lm.prefill`'s docstring say
padding is not valid for recurrent mixers (the state integrates the pad
tokens). The port prefills at the exact length. The oracle is therefore the
JAX engine with ``_bucket_prompts`` set false on the instance, the
exact-length path that engine keeps for recurrent families; one test pins
the padding fault, and one compares against the unmodified engine on
prompts whose lengths are already bucket sizes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import EngineUndrained, Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import probe_batch_axes  # noqa: E402

JCFG = jax_reduced(jax_get_config("rwkv6-7b"))
CFG = reduced_config(get_config("rwkv6-7b"))
_PARAMS = {}


def params():
    """JAX float32 params of the reduced model (PRNGKey(0)), the port's copy."""
    if not _PARAMS:
        jp = jlm.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
        _PARAMS["p"] = (jp, lm.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return _PARAMS["p"]


def prompts(n, seed=0):
    """Prompts of 4 to 16 tokens, drawn as the launchers draw them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(4, 17)))
            for _ in range(n)]


def drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.rid)


def jax_engine(jp, exact_length=True, **kw):
    eng = JaxEngine(jp, JCFG, **kw)
    if exact_length:
        eng._bucket_prompts = False
    return eng


def test_engine_matches_jax_engine():
    """6 requests through 4 slots, 6 new tokens each: the first two admit
    waves land before and after the first decode tick, so both sides of the
    cache's bf16-to-float32 token-shift change are served."""
    jp, p = params()
    ps = prompts(6)
    want = drain(jax_engine(jp, batch_slots=4, max_len=64),
                 [JaxRequest(rid=i, prompt=x, max_new_tokens=6)
                  for i, x in enumerate(ps)])
    got = drain(ServeEngine(p, CFG, batch_slots=4, max_len=64),
                [Request(rid=i, prompt=x, max_new_tokens=6)
                 for i, x in enumerate(ps)])
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(6))
    for g, w in zip(got, want):
        assert len(g.out_tokens) == 6
        assert g.out_tokens == w.out_tokens, g.rid


def test_engine_matches_unmodified_jax_engine_at_bucket_lengths():
    """Prompts of 8 and 16 tokens, which the JAX engine does not pad."""
    jp, p = params()
    rng = np.random.default_rng(4)
    ps = [rng.integers(0, CFG.vocab_size, n) for n in (8, 16, 16, 8, 16)]
    want = drain(jax_engine(jp, exact_length=False, batch_slots=4, max_len=64),
                 [JaxRequest(rid=i, prompt=x, max_new_tokens=5)
                  for i, x in enumerate(ps)])
    got = drain(ServeEngine(p, CFG, batch_slots=4, max_len=64),
                [Request(rid=i, prompt=x, max_new_tokens=5)
                 for i, x in enumerate(ps)])
    assert [g.out_tokens for g in got] == [w.out_tokens for w in want]


def test_jax_engine_pads_rwkv_prompts_into_the_state():
    """The reference's fault: a 5-token prompt is prefilled as 8 (three pad
    tokens integrated into the recurrent state), so its decode tokens part
    from the exact-length prefill's, which the port serves."""
    jp, _ = params()
    padded = jax_engine(jp, exact_length=False, batch_slots=1, max_len=64)
    assert padded._bucket_prompts and padded._prefill_bucket(5) == 8
    prompt = np.random.default_rng(6).integers(0, CFG.vocab_size, 5)
    _, cache_pad = padded._prefill(prompt)
    _, cache_exact = jax_engine(jp, batch_slots=1, max_len=64)._prefill(prompt)
    wkv_pad = np.asarray(cache_pad["blocks"]["pos0"]["wkv"])
    wkv_exact = np.asarray(cache_exact["blocks"]["pos0"]["wkv"])
    assert np.abs(wkv_pad - wkv_exact).max() > 1e-2


def shift_dtypes(cache):
    leaves = cache["blocks"]["pos0"]
    return {str(leaves[k].dtype).split(".")[-1] for k in ("shift_tm",
                                                          "shift_cm")}


def test_cache_types_follow_the_jax_engine():
    """The token-shift leaves are bf16 until the first decode tick and
    float32 after it, on both engines, and an early admit is rounded."""
    jp, p = params()
    ps = prompts(1, seed=3)
    jeng = jax_engine(jp, batch_slots=2, max_len=32)
    eng = ServeEngine(p, CFG, batch_slots=2, max_len=32)
    jeng.submit(JaxRequest(rid=0, prompt=ps[0], max_new_tokens=4))
    eng.submit(Request(rid=0, prompt=ps[0], max_new_tokens=4))
    jeng._admit()
    eng._admit()
    assert shift_dtypes(eng.cache) == shift_dtypes(jeng.cache) == {"bfloat16"}
    lane = eng.cache["blocks"]["pos0"]["shift_tm"][:, 0].float()
    np.testing.assert_array_equal(
        lane.numpy(),
        np.asarray(jeng.cache["blocks"]["pos0"]["shift_tm"][:, 0],
                   np.float32))
    _, cache1 = eng._prefill(ps[0])
    exact = cache1["blocks"]["pos0"]["shift_tm"][:, 0]
    assert torch.equal(lane, exact.to(torch.bfloat16).float())
    eng.step()
    jeng.step()
    assert shift_dtypes(eng.cache) == shift_dtypes(jeng.cache) == {"float32"}


def test_probe_finds_each_leafs_batch_axis():
    """Batch 1 coincides with no other axis of the probe's B+1 = 2 tree."""
    cache = lm.init_cache(CFG, 1, 16, device="cpu")
    axes = probe_batch_axes(cache, lm.init_cache(CFG, 2, 16, device="meta"))
    assert axes == {"blocks": {"pos0": {"shift_tm": 1, "shift_cm": 1,
                                        "wkv": 1}}, "len": 0}


def test_requests_that_finish_at_prefill_take_no_slot():
    _, p = params()
    ps = prompts(4, seed=5)
    eng = ServeEngine(p, CFG, batch_slots=1, max_len=32)
    reqs = [Request(rid=0, prompt=ps[0], max_new_tokens=0),
            Request(rid=1, prompt=ps[1], max_new_tokens=1),
            Request(rid=2, prompt=ps[2], max_new_tokens=3)]
    done = drain(eng, reqs)
    assert [len(r.out_tokens) for r in done] == [0, 1, 3]
    first = done[2].out_tokens[0]
    eos = drain(ServeEngine(p, CFG, batch_slots=1, max_len=32),
                [Request(rid=3, prompt=ps[2], max_new_tokens=5,
                         eos_id=first)])
    assert eos[0].out_tokens == [first]


def test_engine_raises_when_undrained():
    _, p = params()
    eng = ServeEngine(p, CFG, batch_slots=1, max_len=32)
    for i, x in enumerate(prompts(2, seed=7)):
        eng.submit(Request(rid=i, prompt=x, max_new_tokens=4))
    with pytest.raises(EngineUndrained) as err:
        eng.run_until_drained(max_ticks=2)
    assert err.value.pending == 2 and err.value.finished == []


def test_launcher_serves_on_the_cpu(capsys):
    done = launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "4", "--slots", "2"])
    assert sorted(len(r.out_tokens) for r in done) == [4, 4, 4]
    assert "tok/s on cpu" in capsys.readouterr().out


class EagerEngine(ServeEngine):
    _compiled = False


def test_compiled_decode_matches_jax_and_eager():
    """The compiled decode (tick 1 eager, then the static-buffer tick that
    updates the cache in place) serves the JAX engine's tokens and the
    eager engine's, on both sides of the bf16 first tick, and leaves the
    eager engine's cache."""
    jp, p = params()
    ps = prompts(7, seed=8)
    want = drain(jax_engine(jp, batch_slots=3, max_len=64),
                 [JaxRequest(rid=i, prompt=x, max_new_tokens=5)
                  for i, x in enumerate(ps)])
    eager = EagerEngine(p, CFG, batch_slots=3, max_len=64)
    compiled = ServeEngine(p, CFG, batch_slots=3, max_len=64)
    runs = [drain(eng, [Request(rid=i, prompt=x, max_new_tokens=5)
                        for i, x in enumerate(ps)])
            for eng in (eager, compiled)]
    for got in runs:
        assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert compiled._decode is not None and eager._decode is None
    assert compiled.decode_ticks == eager.decode_ticks
    for a, b in zip(jax.tree_util.tree_leaves(compiled.cache),
                    jax.tree_util.tree_leaves(eager.cache)):
        assert a.dtype == b.dtype and torch.equal(a, b)
