"""The engines' compiled dispatch (`repro_torch.serve.graphed`) and the SNN
engine's double-buffered upload, held against the port's own eager
dispatch at exact equality (integer paths; the LM twin compares the same
float ops on one device).

On the CPU the compiled dispatch is the static-buffer plumbing without a
graph: copy the block and counts in, run the megastep, write V back into
the page's state in place. The ``cuda``-marked twins run it as CUDA graphs
on the card (``pytest -m cuda``), against the eager engine on the CPU.
This file imports no JAX, so its card tests run on a machine without it;
the JAX parity of the double buffer is in `test_torch_serve.py`, of the
decode tick in `test_torch_lm_serve.py`, of the bucketed prefill in
`test_torch_lm_dense.py`.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.configs.impulse_snn import IMDB  # noqa: E402
from repro_torch.core import pipeline, snn  # noqa: E402
from repro_torch.launch.serve_snn import make_requests  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeEngine, SNNServeEngine  # noqa: E402
from repro_torch.serve.engine import tree_leaves  # noqa: E402
from repro_torch.serve.graphed import (GRAPHED_BACKENDS,  # noqa: E402
                                      Graphed, StaticPrefill)

CPU = torch.device("cpu")
BUDGETS = [30, 17, 30, None, 9, 30, 23]
LM_CFG = reduced_config(get_config("rwkv6-7b"))
DENSE_CFG = reduced_config(get_config("llama3.2-1b"))


class EagerSNN(SNNServeEngine):
    _compiled = False


class EagerLM(ServeEngine):
    _compiled = False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


_PROGRAMS = {}


def program(device, domain="int"):
    """The IMDB program from the port's seed-0 weights on ``device``."""
    key = (str(device), domain)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = pipeline.compile_network(
            IMDB, snn.init_fc_snn(0, IMDB, device=device), domain=domain,
            device=device)
    return _PROGRAMS[key]


def scenario_requests(prog, scenario):
    """`test_torch_serve.py`'s two scenarios: ragged budgets and an early
    exit, or Poisson arrivals."""
    if scenario == "poisson":
        return make_requests(prog, 7, 3, 10, 0.85, 0, None, 9.0)
    reqs = make_requests(prog, 7, 3, 10, 0.85, 0)
    for r, budget in zip(reqs, BUDGETS):
        r.max_ticks = budget
    reqs[3].stop_threshold = 8.0
    return reqs


def drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.rid)


def assert_same_drains(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.v_out, w.v_out)
        np.testing.assert_array_equal(g.logits, w.logits)
        assert (g.ticks, g.finish_clock) == (w.ticks, w.finish_clock)
        for a, b in zip(g.report.row_events, w.report.row_events):
            np.testing.assert_array_equal(a, b)


def assert_same_ledgers(a, b):
    sa, sb = a.device_event_stats(), b.device_event_stats()
    assert sa.frames == sb.frames
    for x, y in zip(sa.row_events, sb.row_events):
        np.testing.assert_array_equal(x, y)


def flat(out) -> list:
    """Every tensor of a `MegastepOut`: outputs, rasters and counters (the
    gate counts, or the event counters folded)."""
    ts = [out.v_out, out.logits, out.v_out_traj, out.logits_traj,
          out.frames_consumed] + list(out.rasters or [])
    skips = out.skips
    if hasattr(skips, "fold"):
        skips = skips.fold()
    if hasattr(skips, "row_events"):
        ts += [torch.as_tensor(np.asarray(r)) for r in skips.row_events]
    elif skips is not None:
        ts.append(torch.as_tensor(skips))
    return [t.cpu() for t in ts]


# -- (b) the static-buffer dispatch against the eager megastep ---------------

def check_static_dispatch(device, backend):
    """Two pages holding different requests, each dispatched twice through
    its compiled megastep, both pages before either is read: every output
    and the carried state equal `stream_megastep` on copies of the state."""
    prog = program(device)
    eng = SNNServeEngine(prog, batch_slots=2, pages=2, megastep=4,
                         backend=backend, device=device)
    reqs = make_requests(prog, 4, 3, 10, 0.85, 0)
    reqs[0].max_ticks = 6
    for r in reqs:
        eng.submit(r)
    eng._admit()
    assert eng._dispatch is not None and len(eng._dispatch) == 2
    states = {p: [v.clone() for v in eng.states[p].vs] for p in (0, 1)}
    for _ in range(2):
        blocks = {p: eng._build_block(p)[1:] for p in (0, 1)}
        outs = {p: eng._dispatch[p](*blocks[p]) for p in (0, 1)}
        for p in (0, 1):
            block, counts = blocks[p]
            st, want = pipeline.stream_megastep(
                prog, pipeline.StreamState(vs=tuple(states[p])),
                torch.from_numpy(block).to(device), backend, active=counts)
            for g, w in zip(flat(outs[p]), flat(want)):
                assert torch.equal(g, w)
            for g, w in zip(eng.states[p].vs, st.vs):
                assert torch.equal(g, w)
            states[p] = list(st.vs)
            for i in eng.page_lanes(p):
                eng.slots[i].cursor += 4
    assert not torch.equal(states[0][-1], states[1][-1])


@pytest.mark.parametrize("backend", GRAPHED_BACKENDS)
def test_static_dispatch_equals_eager_megastep(backend):
    check_static_dispatch(CPU, backend)


def test_float_and_host_events_stay_eager():
    assert SNNServeEngine(program(CPU), backend="ref_events",
                          device="cpu")._dispatch is None
    assert SNNServeEngine(program(CPU, "float"), backend="float",
                          device="cpu")._dispatch is None
    assert EagerSNN(program(CPU), device="cpu")._dispatch is None


# -- (c) the double buffer's staged blocks ------------------------------------

def staged_counts(budgets, stop=None, backend="int_ref", domain="int"):
    """Drain requests of the given budgets (2 slots, K = 10) with the
    double buffer; returns (used, rebuilt) and asserts the drain equals
    one without it."""
    prog = program(CPU, domain)

    def reqs():
        rs = make_requests(prog, len(budgets), 3, 10, 0.85, 0)
        for r, b in zip(rs, budgets):
            r.max_ticks = b
        if stop is not None:
            rs[stop].stop_threshold = 1e-6      # exits on its first logit
        return rs
    kw = dict(batch_slots=2, megastep=10, backend=backend, device="cpu")
    eng = SNNServeEngine(prog, double_buffer=True, **kw)
    got = drain(eng, reqs())
    assert_same_drains(got, drain(SNNServeEngine(prog, **kw), reqs()))
    return eng._staged_used, eng._staged_rebuilt


def test_staged_block_used_when_nothing_changed():
    """Two 30-frame requests: ticks 2 and 3 dispatch the staged blocks;
    after tick 3 both are predicted finished and nothing is staged."""
    assert staged_counts([30, 30]) == (2, 0)


def test_staged_block_used_after_a_predicted_eviction():
    """A lane evicted at the end of its budget (10 frames) was left out of
    the staged block, so the block still matches."""
    assert staged_counts([30, 10]) == (2, 0)


def test_staged_block_rebuilt_after_an_early_exit():
    """Request 1 exits inside tick 1: the block staged with its lane is
    dropped and rebuilt at tick 2; tick 3's staged block is used."""
    assert staged_counts([30, 30], stop=1) == (1, 1)


@pytest.mark.parametrize("backend,domain", [("int_ref", "int"),
                                            ("float", "float")])
def test_staged_block_rebuilt_after_an_admission(backend, domain):
    """Request 1 (10 frames) leaves after tick 1 and request 2 takes its
    lane at tick 2: the staged block (request 0 alone) is rebuilt; ticks 3
    and 4 use their staged blocks. The eager float dispatch stages the
    same way."""
    assert staged_counts([30, 10, 30], backend=backend,
                         domain=domain) == (2, 1)


# -- (e) the LM engine's compiled decode tick --------------------------------

def lm_drain(engine_cls, params, device, slots=4, n=6, new=6, cfg=LM_CFG,
             max_len=64, hi=17):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, hi)))
               for _ in range(n)]
    eng = engine_cls(params, cfg, batch_slots=slots, max_len=max_len)
    done = drain(eng, [Request(rid=i, prompt=p, max_new_tokens=new)
                       for i, p in enumerate(prompts)])
    return done, eng


def check_compiled_decode(device):
    """6 requests through 4 slots, 6 tokens each: the first admit wave
    lands before the first (eager, bf16-leaf) tick and the second after
    it; the compiled engine serves the eager engine's tokens and ends with
    its cache, and after tick 1 keeps the same cache tensors."""
    params = lm.init_params(0, LM_CFG, dtype=torch.float32, device=device)
    want, eager = lm_drain(EagerLM, params, device)
    eng = ServeEngine(params, LM_CFG, batch_slots=4, max_len=64)
    for i, p in enumerate([np.arange(5), np.arange(7)]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.step()
    ids = [id(t) for t in tree_leaves(eng.cache)]
    eng.run_until_drained()
    assert [id(t) for t in tree_leaves(eng.cache)] == ids
    got, eng = lm_drain(ServeEngine, params, device)
    assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert all(len(g.out_tokens) == 6 for g in got)
    assert eng.decode_ticks == eager.decode_ticks > 2
    for a, b in zip(tree_leaves(eng.cache), tree_leaves(eager.cache)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return eng


def test_compiled_decode_equals_eager_decode():
    eng = check_compiled_decode(CPU)
    assert eng._decode is not None and eng._decode.graph is None


def check_bucket_prefill(device):
    """A dense attention stack: 9 prompts of 4 to 70 tokens through 3
    slots; the compiled engine (one static-buffer prefill per length
    bucket, the decode tick from tick 2) serves the eager engine's tokens,
    keeps the same buckets in its LRU and ends with the same cache."""
    params = lm.init_params(0, DENSE_CFG, dtype=torch.float32, device=device)
    kw = dict(cfg=DENSE_CFG, slots=3, n=9, max_len=128, hi=71)
    want, eager = lm_drain(EagerLM, params, device, **kw)
    got, eng = lm_drain(ServeEngine, params, device, **kw)
    assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert list(eng._prefill_cache) == list(eager._prefill_cache)
    assert len(eng._prefill_cache) >= 3
    assert all(isinstance(f, StaticPrefill)
               for f in eng._prefill_cache.values())
    for a, b in zip(tree_leaves(eng.cache), tree_leaves(eager.cache)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return eng


def test_bucket_prefill_equals_eager_prefill():
    eng = check_bucket_prefill(CPU)
    assert all(f._run.graph is None for f in eng._prefill_cache.values())


# -- (f) the same on the card -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", GRAPHED_BACKENDS)
def test_static_dispatch_equals_eager_megastep_on_the_card(cuda_device,
                                                           backend):
    check_static_dispatch(cuda_device, backend)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["early_exit", "poisson"])
@pytest.mark.parametrize("pages,megastep", [(1, 1), (2, 4), (3, 10)])
@pytest.mark.parametrize("backend", GRAPHED_BACKENDS)
def test_graphed_double_buffer_engine_on_the_card(cuda_device, backend,
                                                  pages, megastep, scenario):
    """Graphed pages with the pinned double buffer on the card equal the
    eager int_ref engine on the CPU (the ref_events engine's ledger for
    cuda_events), and a drain counts the eager drain's launches."""
    kw = dict(batch_slots=2, pages=pages, megastep=megastep)
    host_backend = "ref_events" if backend == "cuda_events" else "int_ref"
    ref = EagerSNN(program(CPU), backend=host_backend, device="cpu", **kw)
    want = drain(ref, scenario_requests(program(CPU), scenario))
    prog = program(cuda_device)
    counts = {}
    for cls, db in ((EagerSNN, False), (SNNServeEngine, True)):
        eng = cls(prog, backend=backend, double_buffer=db, device=cuda_device,
                  **kw)
        kernels.reset_launch_counts()
        got = drain(eng, scenario_requests(prog, scenario))
        counts[cls] = dict(kernels.LAUNCH_COUNTS)
        assert_same_drains(got, want)
        if backend == "cuda_events":
            assert_same_ledgers(eng, ref)
    assert eng._dispatch[0]._run.graph is not None
    assert eng._staged_used > 0
    assert counts[EagerSNN] == counts[SNNServeEngine]


@pytest.mark.cuda
def test_compiled_decode_equals_eager_decode_on_the_card(cuda_device):
    eng = check_compiled_decode(cuda_device)
    assert eng._decode.graph is not None


@pytest.mark.cuda
def test_bucket_prefill_equals_eager_prefill_on_the_card(cuda_device):
    eng = check_bucket_prefill(cuda_device)
    assert all(f._run.graph is not None
               for f in eng._prefill_cache.values())
    assert eng._decode.graph is not None


@pytest.mark.cuda
def test_capture_holds_off_python_collection(cuda_device):
    """A graph held in a reference cycle and dropped while another graph
    is being captured must not be freed mid-capture (that invalidates the
    capture): `Graphed` turns automatic collection off while it captures.
    The body drops such a cycle during the capture and then allocates,
    with the collector set to run at every allocation."""
    x = torch.zeros(8, device=cuda_device)

    def step():
        x.add_(1)
        return x * 2
    spare = {"g": Graphed(step, cuda_device)}
    calls = []

    def body():
        calls.append(len(calls))
        if len(calls) == 2:                        # the capture
            cycle = {"g": spare.pop("g")}
            cycle["self"] = cycle
            del cycle
            _ = [[] for _ in range(100)]           # a collection's trigger
        return step()
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = Graphed(body, cuda_device)
    finally:
        gc.set_threshold(*threshold)
    assert gc.isenabled() and g.graph is not None and not spare
    gc.collect()
    before = x.clone()
    out = g()
    torch.cuda.synchronize()
    assert torch.equal(x, before + 1) and torch.equal(out, x * 2)
