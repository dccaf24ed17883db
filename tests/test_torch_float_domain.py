"""The port's float (QAT) domain against the JAX package's, on the CPU: the
surrogate spike, fake-quant weights, the neuron step, `run_float` on the
IMDB net and on LeNet5-mod, the float backend on an int program, and the
float streaming entries and engine.

Parameters are the JAX package's (`init_fc_snn` / `init_lenet_snn` from
PRNGKey(0)) carried across as numpy arrays; inputs come from numpy seeds.
Tolerances: element-wise ops in the same f32 order are compared exactly
(spike forward and its surrogate, fake-quant bits, neuron steps, rasters);
an FC product sums its f32 terms in XLA's order on one side and in
another BLAS's on the other, so V, logits and reduced gradients are held
to 1e-5 relative / 1e-5 absolute, and rasters exactly (a flipped spike
would show as a raster difference, none does at these seeds).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import check_program as jax_check_program  # noqa: E402
from repro.configs.impulse_snn import IMDB as JAX_IMDB  # noqa: E402
from repro.configs.impulse_snn import MNIST as JAX_MNIST  # noqa: E402
from repro.core import neuron as jneuron  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro.serve import SNNRequest as JaxRequest  # noqa: E402
from repro.serve import SNNServeEngine as JaxEngine  # noqa: E402
from repro_torch.analysis import (ContractError,  # noqa: E402
                                  check_kernel_contracts, check_program)
from repro_torch.configs.impulse_snn import IMDB, MNIST  # noqa: E402
from repro_torch.core import neuron, pipeline, quant, snn  # noqa: E402
from repro_torch.data.synthetic import mnist_like_batch  # noqa: E402
from repro_torch.serve import SNNRequest, SNNServeEngine  # noqa: E402

RTOL = ATOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_PARAMS = {}


def imdb_params():
    """(JAX IMDB params from PRNGKey(0), the port's CPU copy)."""
    if "imdb" not in _PARAMS:
        jp = jsnn.init_fc_snn(jax.random.PRNGKey(0), JAX_IMDB)
        _PARAMS["imdb"] = (jp, snn.params_from_arrays(np_tree(jp), "cpu"))
    return _PARAMS["imdb"]


def lenet_params():
    if "lenet" not in _PARAMS:
        jp = jsnn.init_lenet_snn(jax.random.PRNGKey(0), JAX_MNIST)
        _PARAMS["lenet"] = (jp, snn.params_from_arrays(np_tree(jp), "cpu"))
    return _PARAMS["lenet"]


def words(B, n_words, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n_words, 100)) * 0.8).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol)


def equal(got, want):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(g, np.asarray(want))


# ---------------------------------------------------------------------------
# spike, fake-quant, neuron step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("th_shape", [(), (7,), (1, 7)])
@pytest.mark.parametrize("width", [1.0, 0.5])
def test_spike_forward_and_vjp_match_jax(th_shape, width):
    """Forward and dv exact (the same f32 element-wise ops); the
    threshold's cotangent is a sum over the broadcast axes: 1e-6
    relative."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((5, 7)).astype(np.float32)
    th = (rng.random(th_shape) * 0.5 + 0.2).astype(np.float32)
    g = rng.standard_normal((5, 7)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jneuron.spike(a, b, width),
                       jnp.asarray(v), jnp.asarray(th))
    jgv, jgth = vjp(jnp.asarray(g))
    tv = torch.tensor(v, requires_grad=True)
    tth = torch.tensor(th, requires_grad=True)
    s = neuron.spike(tv, tth, width)
    gv, gth = torch.autograd.grad(s, [tv, tth], torch.tensor(g))
    equal(s, out)
    equal(gv, jgv)
    assert gth.shape == th.shape
    close(gth, jgth, rtol=1e-6, atol=1e-6)


def test_spike_with_a_python_threshold_has_no_threshold_gradient():
    v = torch.tensor([0.2, 0.9, 1.4], requires_grad=True)
    s = neuron.spike(v, 1.0)
    (gv,) = torch.autograd.grad(s.sum(), [v])
    equal(s, [0.0, 0.0, 1.0])
    close(gv, np.maximum(0.0, 1.0 - np.abs(v.detach().numpy() - 1.0)))


def test_fake_quant_bits_and_ste_gradient_match_jax():
    w = (np.random.default_rng(4).standard_normal((100, 128)) * 0.3
         ).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((100, 128)).astype(np.float32)
    out, vjp = jax.vjp(jquant.fake_quant_w, jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    fq = quant.fake_quant_w(tw)
    (gw,) = torch.autograd.grad(fq, [tw], torch.tensor(g))
    equal(fq, out)
    equal(gw, vjp(jnp.asarray(g))[0])
    wq, scale = quant.quantize_w(torch.tensor(w))
    jwq, jscale = jquant.quantize_w(jnp.asarray(w))
    equal(quant.dequantize_w(wq, scale), jquant.dequantize_w(jwq, jscale))
    for x in (0.5, 1.7, -3.2, 1e4):
        assert int(quant.quantize_const(x, scale)) == int(
            jquant.quantize_const(x, jscale))


@pytest.mark.parametrize("leak_mode", ["subtractive", "multiplicative"])
@pytest.mark.parametrize("neuron_type", ["if", "lif", "rmp"])
def test_neuron_step_matches_jax(neuron_type, leak_mode):
    """Three chained steps: V and spikes exact; the gradients of a
    weighted sum of both with respect to V0, the currents, the threshold
    and the leak within 1e-5."""
    rng = np.random.default_rng(6)
    v0 = rng.standard_normal((4, 9)).astype(np.float32)
    cur = (rng.random((3, 4, 9)) * 1.2).astype(np.float32)
    th, lk = np.float32(0.6), np.float32(0.05)
    wv, ws = rng.standard_normal((2, 4, 9)).astype(np.float32)
    kw = dict(neuron=neuron_type, leak_mode=leak_mode, surrogate_width=0.7)

    def jfn(v0, cur, th, lk):
        st, out = jneuron.NeuronState(v0), 0.0
        for t in range(3):
            st, s = jneuron.neuron_step(st, cur[t], threshold=th, leak=lk,
                                        **kw)
            out = out + jnp.sum(s * ws) + jnp.sum(st.v * wv)
        return out, (st.v, s)

    (jout, (jv, js)), jg = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(v0), jnp.asarray(cur), jnp.asarray(th), jnp.asarray(lk))
    args = [torch.tensor(a, requires_grad=True) for a in (v0, cur, th, lk)]
    st, out = neuron.NeuronState(args[0]), 0.0
    for t in range(3):
        st, s = neuron.neuron_step(st, args[1][t], threshold=args[2],
                                   leak=args[3], **kw)
        out = out + torch.sum(s * torch.tensor(ws)) + torch.sum(
            st.v * torch.tensor(wv))
    grads = torch.autograd.grad(out, args, allow_unused=True)
    equal(st.v, jv)
    equal(s, js)
    close(out, jout)
    for g, want in zip(grads, jg):
        close(torch.zeros(want.shape) if g is None else g, want)


def test_accumulate_only_step_and_init_state():
    st = neuron.init_state((2, 3))
    assert st.v.dtype == torch.float32 and not st.v.any()
    cur = torch.arange(6.0).reshape(2, 3)
    equal(neuron.accumulate_only_step(st, cur).v,
          jneuron.accumulate_only_step(jneuron.init_state((2, 3)),
                                       jnp.asarray(cur.numpy())).v)


def test_neuron_step_rejects_unknown_modes():
    st = neuron.init_state((1,))
    with pytest.raises(ValueError, match="neuron"):
        neuron.neuron_step(st, torch.ones(1), neuron="izh", threshold=1.0)
    with pytest.raises(ValueError, match="leak_mode"):
        neuron.neuron_step(st, torch.ones(1), neuron="lif", threshold=1.0,
                           leak_mode="exp")


# ---------------------------------------------------------------------------
# run_float
# ---------------------------------------------------------------------------

def test_compile_network_float_program_matches_jax():
    jp, tp = imdb_params()
    jprog = jpipe.compile_network(JAX_IMDB, jp, validate=False)
    prog = pipeline.compile_network(IMDB, tp, device="cpu")
    assert prog.domain == jprog.domain == "float"
    assert prog.quantize and [ly.kind for ly in prog.layers] == [
        ly.kind for ly in jprog.layers]
    for ly, jly in zip(prog.layers, jprog.layers):
        assert (ly.n_in, ly.n_out, ly.state_shape, ly.quantize) == (
            jly.n_in, jly.n_out, jly.state_shape, jly.quantize)
        for name in ("w", "threshold", "leak"):
            if getattr(jly, name) is None:
                assert getattr(ly, name) is None
            else:
                equal(getattr(ly, name), getattr(jly, name))


@pytest.mark.parametrize("quantize", [True, False])
def test_run_float_imdb_matches_jax(quantize):
    """IMDB at full width, 2 words, B = 4: rasters and spike sums exact,
    logits, rates and the V trace within 1e-5."""
    jp, tp = imdb_params()
    x = words(4, 2, seed=7)
    jprog = jpipe.compile_network(JAX_IMDB, jp, quantize=quantize,
                                  validate=False)
    prog = pipeline.compile_network(IMDB, tp, quantize=quantize, device="cpu")
    kw = dict(return_trace=True, collect_rasters=True, collect_sums=True)
    want = jpipe.run_network(jprog, jpipe.present_words(jnp.asarray(x), 10),
                             "float", **kw)
    got = pipeline.run_network(prog, pipeline.present_words(
        torch.from_numpy(x), 10), "float", **kw)
    assert len(got.rasters) == len(want.rasters) == 3
    for g, w in zip(got.rasters, want.rasters):
        equal(g, w)
    for g, w in zip(got.aux["spike_sums"], want.aux["spike_sums"]):
        equal(g, w)
    close(got.logits, want.logits)
    close(got.aux["spike_rates"], want.aux["spike_rates"])
    close(got.aux["v_trace"], want.aux["v_trace"])
    for g, w in zip(got.v_final, want.v_final):
        close(g, w)


def test_run_float_lenet_matches_jax():
    """LeNet5-mod on a batch of 2: the convs go through `conv2d_f32` (XLA's
    order exactly), the FCs through a BLAS product: logits within 1e-5."""
    jp, tp = lenet_params()
    imgs = mnist_like_batch(2, seed=1)[0]
    want = jsnn.lenet_apply(jp, jnp.asarray(imgs), JAX_MNIST)
    got = snn.lenet_apply(tp, imgs, MNIST, device="cpu")
    close(got, want)
    jprog = jpipe.compile_network(JAX_MNIST, jp, validate=False)
    prog = pipeline.compile_network(MNIST, tp, device="cpu")
    jr = jpipe.run_network(jprog, jnp.asarray(imgs), "float",
                           static_input=True, collect_rasters=True)
    r = pipeline.run_network(prog, torch.from_numpy(imgs), "float",
                             static_input=True, collect_rasters=True)
    for g, w in zip(r.rasters, jr.rasters):
        equal(g, w)


@pytest.mark.parametrize("neuron_type,clamp_mode",
                         [("rmp", "saturate"), ("lif", "wrap"),
                          ("if", "saturate")])
def test_float_backend_on_an_int_program_equals_int_ref(neuron_type,
                                                        clamp_mode):
    """The f32 rendering of an int program is exact: V, logits and every
    raster equal `int_ref` on the same program, and the JAX float backend
    on the JAX program."""
    cfg = dataclasses.replace(IMDB, spiking=dataclasses.replace(
        IMDB.spiking, neuron=neuron_type))
    jcfg = dataclasses.replace(JAX_IMDB, spiking=dataclasses.replace(
        JAX_IMDB.spiking, neuron=neuron_type))
    jp, tp = imdb_params()
    prog = pipeline.compile_network(cfg, tp, domain="int",
                                    clamp_mode=clamp_mode, device="cpu")
    xs = pipeline.present_words(torch.from_numpy(words(3, 2, seed=8)), 10)
    f = pipeline.run_network(prog, xs, "float", collect_rasters=True)
    i = pipeline.run_network(prog, xs, "int_ref")
    equal(f.v_out, i.v_out.to(torch.float32))
    equal(f.logits, i.logits)
    for g, w in zip(f.rasters, i.rasters):
        equal(g, w.to(torch.float32))
    for g, w in zip(f.v_final, i.v_final):
        equal(g, w.to(torch.float32))
    jprog = jpipe.compile_network(jcfg, jp, domain="int",
                                  clamp_mode=clamp_mode, validate=False)
    jf = jpipe.run_network(jprog, jnp.asarray(xs.numpy()), "float")
    equal(f.logits, jf.logits)


def test_float_backend_on_an_int_conv_program_equals_int_ref():
    _, tp = lenet_params()
    prog = pipeline.compile_network(MNIST, tp, domain="int", device="cpu")
    xs = pipeline.present_static(torch.from_numpy(
        mnist_like_batch(2, seed=2)[0]), 10)
    f = pipeline.run_network(prog, xs, "float", collect_rasters=True)
    i = pipeline.run_network(prog, xs, "int_ref")
    equal(f.v_out, i.v_out.to(torch.float32))
    for g, w in zip(f.rasters, i.rasters):
        equal(g, w.to(torch.float32))


def test_kernel_backends_refuse_a_float_program():
    _, tp = imdb_params()
    prog = pipeline.compile_network(IMDB, tp, device="cpu")
    xs = torch.zeros((10, 2, 100))
    for backend in ("int_ref", "cuda", "cuda_events"):
        with pytest.raises(ValueError, match="int-domain"):
            pipeline.run_network(prog, xs, backend)
        with pytest.raises(ValueError, match="int-domain"):
            pipeline.init_stream_state(prog, 2, backend)
        with pytest.raises(ContractError, match="int-domain"):
            check_kernel_contracts(prog, backend)
    with pytest.raises(ValueError, match="domain"):
        pipeline.compile_network(IMDB, tp, domain="half", device="cpu")


def test_rate_coded_program_matches_jax():
    from repro.configs.base import SpikingConfig as JaxSpiking
    from repro_torch.configs.impulse_snn import SpikingConfig
    kw = dict(neuron="lif", timesteps=6, threshold=0.7, leak=0.05)
    prog = pipeline.rate_coded_program(SpikingConfig(**kw), (5,), "cpu")
    jprog = jpipe.rate_coded_program(JaxSpiking(**kw), (5,))
    x = (np.random.default_rng(9).random((3, 5)) * 0.5).astype(np.float32)
    got = pipeline.run_network(prog, torch.from_numpy(x), "float",
                               static_input=True, collect_sums=True)
    want = jpipe.run_network(jprog, jnp.asarray(x), "float",
                             static_input=True, collect_sums=True)
    equal(got.aux["spike_sums"][0], want.aux["spike_sums"][0])
    equal(got.v_out, want.v_out)


def test_check_program_of_a_float_program_is_empty_like_jax():
    jp, tp = imdb_params()
    rep = check_program(pipeline.compile_network(IMDB, tp, device="cpu"))
    jrep = jax_check_program(jpipe.compile_network(JAX_IMDB, jp,
                                                   validate=False))
    assert rep.layers == jrep.layers == ()
    assert rep.domain == jrep.domain == "float"
    assert rep.max_safe_frames is jrep.max_safe_frames is None


# ---------------------------------------------------------------------------
# streaming and serving on the float backend
# ---------------------------------------------------------------------------

def stream_programs():
    jp, tp = imdb_params()
    return (jpipe.compile_network(JAX_IMDB, jp, validate=False),
            pipeline.compile_network(IMDB, tp, device="cpu"))


def test_stream_step_and_megastep_match_jax():
    """Ticks and megasteps of the float program: rasters exact against
    JAX, V within 1e-5; within the port a 3 + 2 megastep equals the five
    ticks and `run_float` bit for bit."""
    jprog, prog = stream_programs()
    frames = (np.random.default_rng(10).random((5, 3, 100)) * 1.5
              ).astype(np.float32)
    jst = jpipe.init_stream_state(jprog, 3, "float")
    st = pipeline.init_stream_state(prog, 3, "float")
    assert all(v.dtype == torch.float32 for v in st.vs)
    ticks = []
    for t in range(5):
        jst, jout = jpipe.stream_step(jprog, jst, jnp.asarray(frames[t]),
                                      "float")
        st, out = pipeline.stream_step(prog, st, torch.from_numpy(frames[t]),
                                       "float")
        for g, w in zip(out.rasters, jout.rasters):
            equal(g, w)
        close(out.logits, jout.logits)
        ticks.append(out.logits)
    mst = pipeline.init_stream_state(prog, 3, "float")
    jmst = jpipe.init_stream_state(jprog, 3, "float")
    traj = []
    for lo, hi in ((0, 3), (3, 5)):
        mst, mout = pipeline.stream_megastep(prog, mst, frames[lo:hi],
                                             "float")
        jmst, jmout = jpipe.stream_megastep(jprog, jmst,
                                            jnp.asarray(frames[lo:hi]),
                                            "float")
        close(mout.logits_traj, jmout.logits_traj)
        for g, w in zip(mout.rasters, jmout.rasters):
            equal(g, w)
        traj.append(mout.logits_traj)
    equal(torch.cat(traj), torch.stack(ticks))
    for a, b in zip(mst.vs, st.vs):
        equal(a, b)
    run = pipeline.run_network(prog, torch.from_numpy(frames), "float")
    equal(run.logits, ticks[-1])


def test_float_megastep_masks_inactive_frames_like_jax():
    jprog, prog = stream_programs()
    frames = np.ones((4, 2, 100), np.float32)
    st, out = pipeline.stream_megastep(
        prog, pipeline.init_stream_state(prog, 2, "float"), frames, "float",
        active=[2, 4])
    jst, jout = jpipe.stream_megastep(
        jprog, jpipe.init_stream_state(jprog, 2, "float"),
        jnp.asarray(frames), "float", active=jnp.asarray([2, 4]))
    equal(out.frames_consumed, jout.frames_consumed)
    close(out.v_out_traj, jout.v_out_traj)


def float_requests(n, T, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, frames=(rng.random((T - i % 3, 100)) * 1.4
                               ).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("megastep", [1, 4])
def test_float_engine_matches_jax(megastep):
    """`SNNServeEngine(backend="float", validate=True)` against the JAX
    engine on the same float program: no admission cap (a float program
    has no accumulator bound) on both; each request's ticks exact, its
    logits (f32) within 1e-5, its event report exact."""
    jprog, prog = stream_programs()
    jeng = JaxEngine(jprog, batch_slots=3, backend="float",
                     megastep=megastep)
    eng = SNNServeEngine(prog, batch_slots=3, backend="float",
                         megastep=megastep, device="cpu")
    assert eng.max_safe_ticks is None and jeng.max_safe_ticks is None
    for r in float_requests(5, 12, 11, JaxRequest):
        jeng.submit(r)
    for r in float_requests(5, 12, 11, SNNRequest):
        eng.submit(r)
    want = sorted(jeng.run_until_drained(), key=lambda r: r.rid)
    got = sorted(eng.run_until_drained(), key=lambda r: r.rid)
    assert [r.ticks for r in got] == [r.ticks for r in want]
    for g, w in zip(got, want):
        assert g.logits.dtype == g.v_out.dtype == np.float32
        close(g.logits, w.logits)
        assert g.report.events == w.report.events
    assert not any(v.requires_grad for st in eng.states for v in st.vs)


def test_float_engine_refuses_a_kernel_backend_on_a_float_program():
    _, prog = stream_programs()
    with pytest.raises(ContractError, match="int-domain"):
        SNNServeEngine(prog, backend="cuda", device="cpu")


@pytest.mark.parametrize("backend", ["int_ref", "cuda", "cuda_sparse",
                                     "ref_events", "cuda_events"])
def test_apply_int_wrappers_match_jax_int_ref(backend):
    """`sentiment_apply_int` and `lenet_apply_int` on every integer backend
    equal the JAX package's int program (compiled with validate=False) on
    `int_ref`, bit for bit, with equal instruction counts."""
    jp, tp = imdb_params()
    x = words(3, 2, seed=12)
    logits, rasters, counts = snn.sentiment_apply_int(tp, x, IMDB, backend,
                                                      device="cpu")
    jprog = jpipe.compile_network(JAX_IMDB, jp, domain="int", validate=False)
    want = jpipe.run_network(jprog, jpipe.present_words(jnp.asarray(x), 10),
                             "int_ref")
    equal(logits, want.logits[:, 0])
    assert tuple(counts) == tuple(
        jpipe.count_network_instructions(jprog, want.rasters))
    jl, tl = lenet_params()
    imgs = mnist_like_batch(1, seed=3)[0]
    got, _, _ = snn.lenet_apply_int(tl, imgs, MNIST, backend, device="cpu")
    jprog = jpipe.compile_network(JAX_MNIST, jl, domain="int", validate=False)
    equal(got, jpipe.run_network(jprog, jpipe.present_static(
        jnp.asarray(imgs), 10), "int_ref").logits)
