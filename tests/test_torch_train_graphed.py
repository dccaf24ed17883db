"""The compiled train step (`train.compile_train_step`, one CUDA graph of
forward, backward and the optimizer on the card) against the eager
`make_train_step`, and the real-data loaders (`data.imdb`, `data.mnist`)
against the JAX package's.

On the CPU the compiled step runs its body each call through the same
static buffers as on the card: it must equal the eager step bit for bit
(parameters, both moments, steps, losses and gradient norms) over three
steps, for every family a launcher or `chip_smoke.py` trains, with remat,
microbatches and the int8 gradient compression; and the body must read
nothing back to the host, which a capture forbids. The compiled SNN step
is held to the JAX package's ``jax.jit(train_step, donate_argnums=(0,))``
within `tests/test_torch_train.py`'s tolerances (loss 1e-5 relative,
gradient norm 1e-4 relative, parameters 1e-5 absolute).

JAX is imported inside the tests that use it, so the ``cuda``-marked
twins run on a machine without it: there the captured graph is held to
the eager step bit for bit, or, where two eager runs already differ (an
atomic sum in a backward), within twice their own difference.
"""
import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs.base import (ParallelConfig, RunConfig,  # noqa: E402
                                      ShapeConfig, get_config, reduced_config)
from repro_torch.configs.impulse_snn import IMDB, MNIST  # noqa: E402
from repro_torch.core import snn  # noqa: E402
from repro_torch.data import imdb, loader, mnist, synthetic  # noqa: E402
from repro_torch.launch import train_snn  # noqa: E402
from repro_torch.models import lstm_baseline as lstm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import (LoopConfig, TrainState,  # noqa: E402
                               compile_train_step, init_train_state,
                               make_train_step, train_loop)
from repro_torch.tree import tree_flatten_with_paths, tree_map  # noqa: E402

STEPS = 3
CASES = ("snn", "lenet", "lstm", "llama3.2", "rwkv", "microbatches",
         "grad_compress")
LOSS_RTOL, GRAD_RL2, PARAM_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# -- the cases ----------------------------------------------------------------

def snn_case(device, microbatches=1, grad_compress=False):
    """The IMDB SNN at B = 8, 2 words, AdamW lr 5e-3 without decay, clip
    at 1.0 (`test_snn_adamw_steps_match_jax`'s run)."""
    opt = adamw(lambda s: 5e-3, weight_decay=0.0)
    run = RunConfig(model=IMDB, shape=ShapeConfig("imdb", 20, 8, "train"),
                    parallel=ParallelConfig(microbatches=microbatches,
                                            grad_compress=grad_compress))
    step = make_train_step(run, opt, lambda p, b: snn.sentiment_loss(
        p, b["x"], b["y"], IMDB, device=device))
    params = snn.init_fc_snn(0, IMDB, device=device)
    ds = synthetic.make_sentiment_vocab(0)
    return step, TrainState(params, opt.init(params), step0(device)), (
        lambda s: dict(zip(("x", "y"),
                           synthetic.sentiment_batch(ds, 8, 2, seed=s))))


def lenet_case(device):
    """LeNet5-mod (`lenet_loss`) at batch 2, AdamW without decay, no
    clip."""
    opt = adamw(lambda s: 5e-3, weight_decay=0.0)
    step = make_train_step(RunConfig(model=None, shape=None), opt,
                           lambda p, b: snn.lenet_loss(p, b["x"], b["y"],
                                                       MNIST, device=device),
                           max_grad_norm=float("inf"))
    params = snn.init_lenet_snn(0, MNIST, device=device)
    return step, TrainState(params, opt.init(params), step0(device)), (
        lambda s: dict(zip(("x", "y"), synthetic.mnist_like_batch(2, s))))


def lstm_case(device):
    """The Fig. 9b LSTM baseline on the SNN's batches (B = 8, 2 words)."""
    opt = adamw(lambda s: 5e-3, weight_decay=0.0)
    step = make_train_step(RunConfig(model=None, shape=None), opt,
                           lambda p, b: lstm.lstm_loss(p, b["x"], b["y"]),
                           max_grad_norm=float("inf"))
    params = lstm.init_lstm(1, device=device)
    ds = synthetic.make_sentiment_vocab(0)
    return step, TrainState(params, opt.init(params), step0(device)), (
        lambda s: dict(zip(("x", "y"),
                           synthetic.sentiment_batch(ds, 8, 2, seed=s))))


def lm_case(device, arch, **parallel):
    """``reduced_config(arch)`` in float32 at B = 2, seq 16, remat per
    block, the default step (`lm.loss_fn`, AdamW with a cosine warm-up)."""
    cfg = reduced_config(get_config(arch))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"),
                    parallel=ParallelConfig(remat="block", **parallel),
                    optimizer="adamw", learning_rate=1e-3, warmup_steps=2)
    state, opt = init_train_state(0, run, total_steps=8, dtype=torch.float32,
                                  device=device)
    batches = loader.lm_batch_fn(cfg.vocab_size, 2, 16, 0)
    return make_train_step(run, opt), state, lambda s: batches(s, 0, 1)


def case(name, device):
    """(eager train step, initial state, batch of step s) of a case."""
    if name == "lenet":
        return lenet_case(device)
    if name == "lstm":
        return lstm_case(device)
    if name == "llama3.2":
        return lm_case(device, "llama3.2-1b")
    if name == "rwkv":
        return lm_case(device, "rwkv6-7b", wkv_chunk=16)
    if name == "microbatches":
        return lm_case(device, "llama3.2-1b", microbatches=2)
    return snn_case(device, grad_compress=name == "grad_compress")


def step0(device):
    return torch.zeros((), dtype=torch.int32, device=device)


def clone(state):
    return tree_map(lambda x: x.clone(), state)


class NoHostReads(TorchDispatchMode):
    """Raises on an operator that reads device data back to the host or
    whose output shape depends on the data: a CUDA graph capture cannot
    record either."""

    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default,
                 torch.ops.aten.nonzero.default,
                 torch.ops.aten.masked_select.default,
                 torch.ops.aten._unique2.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"{func} inside a compiled train step")
        return func(*args, **(kwargs or {}))


def run_steps(step, state, batch_of, device, n=STEPS, guard=False):
    """``n`` steps of ``step`` from ``state``, batch s on ``device``:
    (final state, [metrics as floats])."""
    metrics = []
    for s in range(n):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch_of(s).items()}
        if guard:
            with NoHostReads():
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def differences(a, b) -> dict:
    """{leaf path: largest |a - b|} over the leaves that differ."""
    out = {}
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a),
                                 tree_flatten_with_paths(b)):
        if not torch.equal(x, y):
            out["/".join(map(str, path))] = float(
                (x.double() - y.double()).abs().max())
    return out


# -- compiled against eager on the CPU ----------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_compiled_step_equals_eager_bit_for_bit(name):
    """Three compiled steps against three eager steps from the same state
    and batches: every state leaf and every metric equal bit for bit; the
    body reads nothing on the host; each call returns the same buffers
    (the state handed in is consumed), and the caller's first state is
    left as it was."""
    cpu = torch.device("cpu")
    step, state, batch_of = case(name, cpu)
    first = clone(state)
    want, want_m = run_steps(step, clone(state), batch_of, cpu)
    compiled = compile_train_step(step, cpu)
    got, got_m = run_steps(compiled, state, batch_of, cpu, guard=True)
    assert got is compiled.state and len(compiled.graphs) == 1
    assert not differences(got, want)
    assert got_m == want_m
    assert [m["step"] for m in got_m] == [1.0, 2.0, 3.0]
    assert not differences(state, first)
    again, _ = compiled(got, {k: torch.as_tensor(v) for k, v in
                              batch_of(STEPS).items()})
    assert again is got and int(got.step) == STEPS + 1


def test_the_warm_up_leaves_the_state_as_it_was(monkeypatch):
    """On the card `Graphed` runs the body once before the capture (the
    warm-up), which advances the state's buffers; the compiled step puts
    the step's input back, at the first call (from the state handed in)
    and at a new batch signature (from a copy of the buffers). Emulated
    here by a `Graphed` that runs its body when it is built: the steps
    still equal the eager ones bit for bit."""
    from repro_torch.serve.graphed import Graphed
    from repro_torch.train import graphed

    class WarmedUp(Graphed):
        def __init__(self, body, device, keep=(), autograd=False):
            super().__init__(body, device, keep, autograd)
            with torch.set_grad_enabled(autograd):
                body()
    monkeypatch.setattr(graphed, "Graphed", WarmedUp)
    cpu = torch.device("cpu")
    step, state, batch_of = case("snn", cpu)
    want, want_m = run_steps(step, clone(state), batch_of, cpu)
    compiled = compile_train_step(step, cpu)
    got, got_m = run_steps(compiled, state, batch_of, cpu)
    assert not differences(got, want) and got_m == want_m
    half = {k: v[:4] for k, v in batch_of(STEPS).items()}
    want, want_m = step(want, half)
    got, got_m = compiled(got, half)
    assert len(compiled.graphs) == 2 and not differences(got, want)
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)


def test_compiled_snn_step_matches_jax_jit_with_donation():
    """The compiled SNN step (from the JAX package's parameters) against
    ``jax.jit(make_train_step(...), donate_argnums=(0,))`` over three
    steps: losses within 1e-5 relative, gradient norms within 1e-4,
    parameters within 1e-5 absolute, as `test_snn_adamw_steps_match_jax`
    holds the eager step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import optim as joptim
    from repro.configs import base as jbase
    from repro.configs.impulse_snn import IMDB as JAX_IMDB
    from repro.core import snn as jsnn
    from repro.train import train_state as jtrain

    jp = jsnn.init_fc_snn(jax.random.PRNGKey(0), JAX_IMDB)
    jopt = joptim.adamw(lambda s: 5e-3, weight_decay=0.0)
    jrun = jbase.RunConfig(model=JAX_IMDB,
                           shape=jbase.ShapeConfig("imdb", 20, 8, "train"),
                           parallel=jbase.ParallelConfig())
    jstep = jax.jit(jtrain.make_train_step(
        jrun, jopt, lambda p, b: jsnn.sentiment_loss(p, b["x"], b["y"],
                                                     JAX_IMDB)),
        donate_argnums=(0,))
    jstate = jtrain.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    step, _, batch_of = snn_case("cpu")
    params = snn.params_from_arrays(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    opt = adamw(lambda s: 5e-3, weight_decay=0.0)
    state = TrainState(params, opt.init(params), step0("cpu"))
    compiled = compile_train_step(step, "cpu")
    for s in range(STEPS):
        b = batch_of(s)
        state, m = compiled(state, b)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_RL2)
        assert int(m["step"]) == int(jm["step"]) == s + 1
    for (path, got), want in zip(tree_flatten_with_paths(state.params),
                                 jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


def test_train_loop_resumes_through_the_compiled_step(tmp_path):
    """`train_loop` over the compiled step, checkpointed every 2 steps and
    stopped at 2, then restarted to 4 with a new compiled step and a fresh
    state: it resumes from step 2, the restored state is copied into the
    buffers (the returned state is them), and it ends equal bit for bit to
    an uninterrupted compiled run and to the eager loop."""
    cpu = torch.device("cpu")

    def loop(step, total, ckpt_dir=None):
        _, state, batch_of = case("snn", cpu)
        return train_loop(
            step, state, loader.ShardedLoader(lambda s, i, n: batch_of(s)),
            LoopConfig(total_steps=total, ckpt_every=2, log_every=1,
                       ckpt_dir=ckpt_dir))

    eager = case("snn", cpu)[0]
    d = str(tmp_path / "ckpt")
    first = loop(compile_train_step(eager, cpu), 2, d)
    assert first.resumed_from is None and int(first.state.step) == 2
    compiled = compile_train_step(eager, cpu)
    second = loop(compiled, 4, d)
    assert second.resumed_from == 2 and second.state is compiled.state
    assert [m["step"] for m in second.metrics_history] == [3.0, 4.0]
    whole = loop(compile_train_step(eager, cpu), 4)
    plain = loop(eager, 4)
    assert not differences(second.state, whole.state)
    assert not differences(whole.state, plain.state)
    assert [m["loss"] for m in whole.metrics_history] == [
        m["loss"] for m in plain.metrics_history]


def test_checkpoint_save_snapshots_the_buffers_before_the_next_step(
        tmp_path, monkeypatch):
    """An asynchronous `CheckpointManager.save` of the compiled step's
    state copies it on the caller's thread, so the next steps, which
    overwrite the buffers in place while the write is in flight (held
    here until they are done), do not reach the checkpoint."""
    import threading

    from repro_torch.checkpoint import CheckpointManager, ckpt as ckpt_mod
    cpu = torch.device("cpu")
    step, state, batch_of = case("snn", cpu)
    compiled = compile_train_step(step, cpu)
    state, _ = compiled(state, batch_of(0))
    want = clone(state)
    steps_done, savez = threading.Event(), np.savez

    def held_savez(*args, **kw):
        steps_done.wait(timeout=60)
        return savez(*args, **kw)
    monkeypatch.setattr(ckpt_mod.np, "savez", held_savez)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    for s in range(1, 4):
        state, _ = compiled(state, batch_of(s))
    steps_done.set()
    _, got = ckpt.restore(like=state)
    assert int(state.step) == 4 and int(got.step) == 1
    assert not differences(got, want)


def test_refusals():
    """A sharded (DTensor) state is refused by name, and so is a state
    whose leaves do not fit the buffers."""
    from torch.distributed.tensor import DTensor
    cpu = torch.device("cpu")
    step, state, batch_of = case("snn", cpu)
    compiled = compile_train_step(step, cpu)
    fake = torch.Tensor._make_subclass(DTensor, torch.zeros(2))
    sharded = state._replace(step=fake)
    with pytest.raises(ValueError, match="sharded \\(DTensor\\)"):
        compiled(sharded, batch_of(0))
    compiled(state, batch_of(0))
    with pytest.raises(ValueError, match="state leaf"):
        compiled(state._replace(step=torch.zeros(2, dtype=torch.int32)),
                 batch_of(1))


# -- the card twins -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_captured_step_equals_eager_on_the_card(cuda_device, name):
    """The captured graph on the card against the eager step, three steps
    from one state and one batch stream: bit for bit where two eager runs
    agree; where they differ (an atomic sum in a backward), every leaf's
    largest difference from the first eager run within twice the second's,
    and no leaf that the eager runs agree on differing."""
    step, state, batch_of = case(name, cuda_device)
    a, a_m = run_steps(step, clone(state), batch_of, cuda_device)
    b, b_m = run_steps(step, clone(state), batch_of, cuda_device)
    compiled = compile_train_step(step, cuda_device)
    c, c_m = run_steps(compiled, state, batch_of, cuda_device)
    assert compiled.graphs[next(iter(compiled.graphs))][1].graph is not None
    own, got = differences(b, a), differences(c, a)
    if not own:
        assert not got and c_m == a_m
    else:
        assert set(got) <= set(own), sorted(set(got) - set(own))
        assert all(got[k] <= 2 * own[k] for k in got), (got, own)


@pytest.mark.cuda
def test_a_second_batch_signature_on_the_card(cuda_device):
    """A batch of another shape captures a second graph, whose warm-up
    leaves the state as it was: the step equals the eager one."""
    step, state, batch_of = case("snn", cuda_device)
    compiled = compile_train_step(step, cuda_device)
    state, _ = run_steps(compiled, state, batch_of, cuda_device)
    half = {k: torch.as_tensor(v[:4], device=cuda_device)
            for k, v in batch_of(STEPS).items()}
    want, want_m = step(clone(state), half)
    got, got_m = compiled(state, half)
    assert len(compiled.graphs) == 2 and not differences(got, want)
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)


# -- the real-data loaders --------------------------------------------------------

def write_imdb(root):
    """A 3-word, 100-d GloVe file and a 2 + 2-review aclImdb train split
    (one review without a known word, dropped by `vectorize`)."""
    rng = np.random.default_rng(7)
    glove = root / "glove.txt"
    with open(glove, "w", encoding="utf-8") as f:
        for word in ("good", "bad", "movie"):
            vec = " ".join(f"{v:.6f}" for v in rng.standard_normal(100))
            f.write(f"{word} {vec}\n")
    reviews = {"pos": ["A good movie!", "Good, good (GOOD) movie."],
               "neg": ["Bad movie <br/>", "nothing known here"]}
    for sub, texts in reviews.items():
        d = root / "aclImdb" / "train" / sub
        d.mkdir(parents=True)
        for i, text in enumerate(texts):
            (d / f"{i}_7.txt").write_text(text, encoding="utf-8")
    return root / "aclImdb", glove


def test_imdb_loader_equals_jax(tmp_path, monkeypatch):
    """`available`, `load_glove`, `load_reviews` (with and without a
    limit) and `vectorize` against the JAX package's on test-written
    files: equal bit for bit."""
    from repro.data import imdb as jimdb
    d, glove = write_imdb(tmp_path)
    assert not imdb.available() or imdb.IMDB_DIR != str(d)
    for mod in (imdb, jimdb):
        monkeypatch.setattr(mod, "IMDB_DIR", str(d))
        monkeypatch.setattr(mod, "GLOVE_PATH", str(glove))
    assert imdb.available() and jimdb.available()
    vecs, jvecs = imdb.load_glove(), jimdb.load_glove()
    assert sorted(vecs) == sorted(jvecs) == ["bad", "good", "movie"]
    for word in vecs:
        np.testing.assert_array_equal(vecs[word], jvecs[word])
    for limit in (None, 2):
        reviews = imdb.load_reviews("train", limit)
        assert reviews == jimdb.load_reviews("train", limit)
    x, y = imdb.vectorize(imdb.load_reviews("train"), vecs, n_words=4)
    jx, jy = jimdb.vectorize(jimdb.load_reviews("train"), jvecs, n_words=4)
    assert x.shape == (3, 4, 100) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(x[1, :4], np.stack([vecs["good"]] * 3
                                                     + [vecs["movie"]]))


def write_idx(path, array: np.ndarray) -> None:
    """``array`` (uint8) as a gzip idx file."""
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + array.tobytes())


def test_mnist_loader_equals_jax(tmp_path, monkeypatch):
    """`available` and `load` of both splits against the JAX package's on
    gzip idx files the test writes: equal bit for bit, images scaled to
    [0, 1] with a channel axis, labels int32."""
    from repro.data import mnist as jmnist
    rng = np.random.default_rng(3)
    for pre, n in (("train", 5), ("t10k", 3)):
        write_idx(tmp_path / f"{pre}-images-idx3-ubyte.gz",
                  rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        write_idx(tmp_path / f"{pre}-labels-idx1-ubyte.gz",
                  rng.integers(0, 10, (n,), dtype=np.uint8))
    for mod in (mnist, jmnist):
        monkeypatch.setattr(mod, "MNIST_DIR", str(tmp_path))
    assert mnist.available() and jmnist.available()
    for split, n in (("train", 5), ("test", 3)):
        (x, y), (jx, jy) = mnist.load(split), jmnist.load(split)
        assert x.shape == (n, 28, 28, 1) and y.dtype == np.int32
        assert 0.0 <= x.min() and x.max() <= 1.0
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_train_snn_launcher_trains_on_real_imdb_when_present(
        tmp_path, monkeypatch, capsys):
    """With the IMDB and GloVe files present, the launcher says so and
    trains and evaluates on them (the eval set is the first reviews, as
    in the JAX example); without them it takes the synthetic task."""
    d, glove = write_imdb(tmp_path)
    args = ["--device", "cpu", "--steps", "2", "--batch", "4", "--words",
            "4", "--backend", "int_ref"]
    monkeypatch.setattr(imdb, "IMDB_DIR", str(tmp_path / "absent"))
    train_snn.main(args)
    assert "data: synthetic (structure-matched)" in capsys.readouterr().out
    monkeypatch.setattr(imdb, "IMDB_DIR", str(d))
    monkeypatch.setattr(imdb, "GLOVE_PATH", str(glove))
    acc_f, acc_i = train_snn.main(args)
    out = capsys.readouterr().out
    assert "data: real IMDB+GloVe" in out and "eval accuracy" in out
    assert 0.0 <= acc_f <= 1.0 and 0.0 <= acc_i <= 1.0
