"""The port's training path against the JAX package's, on the CPU: the
synthetic data, the task losses and their gradients, the optimizers and
schedule, gradient compression, the train step (microbatches included),
checkpoints (in both directions between the packages), the loader, the
fault-tolerant loop and the `train_snn` launcher.

Parameters are the JAX package's, carried across as numpy arrays. Losses
are compared within 1e-5 relative, gradients within 1e-4 relative L2 (an
FC product's f32 sum runs in XLA's order on one side and another BLAS's on
the other); element-wise updates (optimizers, schedule, compression) in
the same f32 ops within 1e-6.
"""
import signal

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.impulse_snn import IMDB as JAX_IMDB  # noqa: E402
from repro.configs.impulse_snn import MNIST as JAX_MNIST  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.dist.compress import fake_compress as jax_fake_compress  # noqa: E402
from repro.models import lstm_baseline as jlstm  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import train_state as jtrain  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (ParallelConfig, RunConfig,  # noqa: E402
                                      ShapeConfig)
from repro_torch.configs.impulse_snn import IMDB, MNIST  # noqa: E402
from repro_torch.core import snn  # noqa: E402
from repro_torch.data import loader, synthetic  # noqa: E402
from repro_torch.dist.compress import fake_compress  # noqa: E402
from repro_torch.launch import train_snn  # noqa: E402
from repro_torch.models import lstm_baseline as lstm  # noqa: E402
from repro_torch.train import (LoopConfig, TrainState,  # noqa: E402
                               init_train_state, make_train_step, train_loop)
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                               tree_unflatten_like)

LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
ELEM = 1e-6


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x)), np_tree(tree))


def rel_l2(got, want):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def assert_trees_close(got, want, rtol=ELEM, atol=ELEM):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a.detach().numpy() if torch.is_tensor(a) else np.asarray(a),
            np.asarray(b), rtol=rtol, atol=atol)


def grads_of(loss_fn, params):
    """(loss, aux, grads) of ``loss_fn(params)`` by autograd, unused leaves
    as zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten_like(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), aux, [torch.zeros_like(p) if g is None else g
                       for p, g in zip(leaves, grads)]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_data_is_bit_equal(seed):
    ds, jds = (synthetic.make_sentiment_vocab(seed),
               jdata.make_sentiment_vocab(seed))
    for name in ("vectors", "polarity", "is_negator"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    for a, b in zip(synthetic.sentiment_batch(ds, 16, 12, seed=seed + 5),
                    jdata.sentiment_batch(jds, 16, 12, seed=seed + 5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(synthetic.lm_token_batch(3, 70, 97, seed),
                                  jdata.lm_token_batch(3, 70, 97, seed))
    for a, b in zip(synthetic.mnist_like_batch(4, seed),
                    jdata.mnist_like_batch(4, seed)):
        np.testing.assert_array_equal(a, b)
    assert (synthetic.GLOVE_DIM, synthetic.VOCAB, synthetic.NEG_WORDS) == (
        jdata.GLOVE_DIM, jdata.VOCAB, jdata.NEG_WORDS)


def test_loader_is_deterministic_and_resumes_like_jax():
    fn = loader.lm_batch_fn(vocab=97, global_batch=8, seq=16, seed=3)
    jfn = jloader.lm_batch_fn(vocab=97, global_batch=8, seq=16, seed=3)
    for shard in (0, 1):
        for k, v in fn(5, shard, 2).items():
            np.testing.assert_array_equal(v, jfn(5, shard, 2)[k])
    assert not np.array_equal(fn(5, 0, 2)["tokens"], fn(5, 1, 2)["tokens"])
    with pytest.raises(ValueError, match="shard"):
        fn(0, 0, 3)
    l1 = loader.ShardedLoader(fn, start_step=0)
    first = [next(l1) for _ in range(4)]
    l1.close()
    l2 = loader.ShardedLoader(fn, start_step=2)
    s, b = next(l2)
    l2.close()
    assert [s for s, _ in first] == [0, 1, 2, 3] and s == 2
    np.testing.assert_array_equal(b["tokens"], first[2][1]["tokens"])
    for start, shard in ((0, 0), (3, 1)):     # fresh and resumed, per shard
        ours = loader.ShardedLoader(fn, shard_id=shard, num_shards=2,
                                    start_step=start)
        theirs = jloader.ShardedLoader(jfn, shard_id=shard, num_shards=2,
                                       start_step=start)
        for _ in range(3):
            (s, b), (js, jb) = next(ours), next(theirs)
            assert s == js
            assert b.keys() == jb.keys()
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])
        ours.close()
        theirs.close()
        ours._thread.join(timeout=5)
        assert not ours._thread.is_alive()
    l1._thread.join(timeout=5)
    l2._thread.join(timeout=5)
    assert not l1._thread.is_alive() and not l2._thread.is_alive()


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def sentiment_case(B=8, n_words=2, seed=0):
    jp = jsnn.init_fc_snn(jax.random.PRNGKey(0), JAX_IMDB)
    x, y = synthetic.sentiment_batch(synthetic.make_sentiment_vocab(0), B,
                                     n_words, seed=seed)
    return jp, x, y


def test_sentiment_loss_and_gradients_match_jax():
    jp, x, y = sentiment_case()
    (jl, jaux), jg = jax.value_and_grad(jsnn.sentiment_loss, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(y), JAX_IMDB)
    loss, aux, grads = grads_of(lambda p: snn.sentiment_loss(
        p, x, y, IMDB, device="cpu"), to_torch(jp))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        assert rel_l2(g, w) < GRAD_RL2 or not np.any(np.asarray(w))
        if not np.any(np.asarray(w)):            # RMP never reads the leak
            assert not g.any()


def test_lenet_loss_and_gradients_match_jax():
    jp = jsnn.init_lenet_snn(jax.random.PRNGKey(0), JAX_MNIST)
    imgs, labels = synthetic.mnist_like_batch(2, seed=0)
    (jl, jaux), jg = jax.value_and_grad(jsnn.lenet_loss, has_aux=True)(
        jp, jnp.asarray(imgs), jnp.asarray(labels), JAX_MNIST)
    loss, aux, grads = grads_of(lambda p: snn.lenet_loss(
        p, imgs, labels, MNIST, device="cpu"), to_torch(jp))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        if np.any(np.asarray(w)):
            assert rel_l2(g, w) < GRAD_RL2
        else:
            assert not g.any()


def test_lstm_loss_and_gradients_match_jax():
    jp = jlstm.init_lstm(jax.random.PRNGKey(1))
    x, y = synthetic.sentiment_batch(synthetic.make_sentiment_vocab(0), 4, 6,
                                     seed=2)
    (jl, jacc), jg = jax.value_and_grad(jlstm.lstm_loss, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(y))
    loss, acc, grads = grads_of(lambda p: lstm.lstm_loss(p, x, y),
                                to_torch(jp))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(acc) == float(jacc)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        assert rel_l2(g, w) < GRAD_RL2
    assert lstm.param_count(to_torch(jp)) == jlstm.param_count(jp) == 248_961
    ours = lstm.init_lstm(1, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(ours)] == [
        tuple(t.shape) for t in jax.tree_util.tree_leaves(jp)]


# ---------------------------------------------------------------------------
# optimizers, schedule, compression
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "adam": lambda m: m.adam(1e-2),
    "adamw": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "adamw_schedule": lambda m: m.adamw(m.cosine_warmup(1e-2, 2, 6)),
    "adafactor": lambda m: m.adafactor(1e-2),
}


def opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32)}],
            "b": rng.standard_normal(4).astype(np.float32),
            "m": rng.standard_normal((2, 3, 4)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Three updates on the same gradients: updates, state and parameters
    within 1e-6."""
    opt, jopt = OPTIMIZERS[name](optim), OPTIMIZERS[name](joptim)
    params, jparams = to_torch(opt_tree(0)), jax.tree_util.tree_map(
        jnp.asarray, opt_tree(0))
    state, jstate = opt.init(params), jopt.init(jparams)
    for k in range(3):
        grads = opt_tree(10 + k)
        upd, state = opt.update(to_torch(grads), state, params)
        jupd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   jstate, jparams)
        assert_trees_close(upd, jupd)
        params = optim.apply_updates(params, upd)
        jparams = joptim.apply_updates(jparams, jupd)
    assert_trees_close(params, jparams)
    assert_trees_close(state, jstate)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32


def test_make_optimizer_names():
    for name in ("sgd", "adam", "adamw", "adafactor"):
        assert isinstance(optim.make_optimizer(name, 1e-3), optim.Optimizer)
    with pytest.raises(ValueError, match="optimizer"):
        optim.make_optimizer("lion", 1e-3)


def test_clip_schedule_and_compression_match_jax():
    grads = opt_tree(4)
    for max_norm in (0.5, 1e3):
        got, norm = optim.clip_by_global_norm(to_torch(grads), max_norm)
        want, jnorm = joptim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        assert float(norm) == pytest.approx(float(jnorm), rel=ELEM)
        assert_trees_close(got, want)
    lr, jlr = (optim.cosine_warmup(3e-3, 10, 100),
               joptim.cosine_warmup(3e-3, 10, 100))
    for step in (0, 1, 5, 10, 11, 55, 100, 130):
        assert float(lr(torch.tensor(step))) == pytest.approx(
            float(jlr(step)), rel=ELEM, abs=1e-12)
    got = fake_compress(to_torch(grads))
    want = jax_fake_compress(jax.tree_util.tree_map(jnp.asarray, grads))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def run_cfg(microbatches=1, grad_compress=False, jax_side=False):
    mod = jbase if jax_side else None
    cls = (mod.RunConfig, mod.ShapeConfig, mod.ParallelConfig) if mod else (
        RunConfig, ShapeConfig, ParallelConfig)
    return cls[0](model=JAX_IMDB if jax_side else IMDB,
                  shape=cls[1]("imdb", 20, 8, "train"),
                  parallel=cls[2](microbatches=microbatches,
                                  grad_compress=grad_compress))


def snn_states(jp, opt, jopt):
    tp = to_torch(jp)
    return (TrainState(tp, opt.init(tp), torch.zeros((), dtype=torch.int32)),
            jtrain.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32)))


def snn_steps(microbatches=1, grad_compress=False, n=3):
    jp, _, _ = sentiment_case()
    ds = synthetic.make_sentiment_vocab(0)
    opt = optim.adamw(lambda s: 5e-3, weight_decay=0.0)
    jopt = joptim.adamw(lambda s: 5e-3, weight_decay=0.0)
    step = make_train_step(run_cfg(microbatches, grad_compress), opt,
                           lambda p, b: snn.sentiment_loss(
                               p, b["x"], b["y"], IMDB, device="cpu"))
    jstep = jtrain.make_train_step(
        run_cfg(microbatches, grad_compress, jax_side=True), jopt,
        lambda p, b: jsnn.sentiment_loss(p, b["x"], b["y"], JAX_IMDB))
    state, jstate = snn_states(jp, opt, jopt)
    for s in range(n):
        x, y = synthetic.sentiment_batch(ds, 8, 2, seed=s)
        state, m = step(state, {"x": x, "y": y})
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_RL2)
        assert int(m["step"]) == int(jm["step"]) == s + 1
    return state, jstate


@pytest.mark.parametrize("microbatches,grad_compress",
                         [(1, False), (2, False), (1, True)])
def test_snn_adamw_steps_match_jax(microbatches, grad_compress):
    """Three AdamW steps of the IMDB SNN through `make_train_step` on both
    sides (clip at 1.0): parameters within 1e-5 absolute (an update is
    lr-sized, 5e-3), the leak untouched (RMP never reads it)."""
    state, jstate = snn_steps(microbatches, grad_compress)
    assert_trees_close(state.params, jstate.params, rtol=0, atol=1e-5)
    assert not (state.params["leak"] - torch.tensor(
        np.asarray(jstate.params["leak"]))).any()


def test_microbatches_match_the_full_batch():
    """Two microbatches of 4 against one batch of 8: the loss and the
    parameters after one step within 1e-5 (the mean of the halves' means
    equals the batch mean up to f32 rounding)."""
    one, _ = snn_steps(1, n=1)
    two, _ = snn_steps(2, n=1)
    assert_trees_close(two.params, one.params, rtol=0, atol=1e-5)


def test_train_step_without_a_loss_fn_names_the_lm_loss():
    """Without a loss the train step takes the language-model loss,
    `lm.loss_fn` of the run's model under the run's parallel config (the
    JAX package's default), on the state `init_train_state` builds."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import lm
    run = RunConfig(model=reduced_config(get_config("llama3.2-1b")),
                    shape=ShapeConfig("lm", 16, 2, "train"),
                    parallel=ParallelConfig(remat="none"))
    state, opt = init_train_state(0, run, total_steps=4,
                                  dtype=torch.float32, device="cpu")
    b = loader.lm_batch_fn(512, 2, 16, seed=0)(0, 0, 1)
    _, m = make_train_step(run, opt)(state, b)
    with torch.no_grad():
        want, _ = lm.loss_fn(state.params, b, run.model, run.parallel)
    assert torch.equal(m["loss"], want)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.tensor(1.5), "h": torch.ones(3,
                                                          dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        mgr.save(s, tree_map(lambda x, s=s: x + s, tree), blocking=True)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    step, restored = mgr.restore(like=tree)
    assert step == 3
    assert restored["b"]["h"].dtype == torch.bfloat16
    for got, want in zip(tree_leaves(restored), tree_leaves(tree)):
        assert torch.equal(got, want + 3)
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(like={"a": tree["a"]})


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    (tmp_path / "step_9.tmp").mkdir()              # a save cut mid-write
    mgr.save(7, {"w": torch.zeros((256, 256))})
    mgr.wait()
    assert (tmp_path / "step_7").exists()
    assert mgr.all_steps() == [7]
    assert not (tmp_path / "step_7.tmp").exists()


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A JAX `TrainState` (IMDB params, AdamW state, step) written by the
    JAX `CheckpointManager` restores into the port's `TrainState` bit for
    bit; the port's save of it restores in the JAX package."""
    jp, _, _ = sentiment_case()
    jopt = joptim.adamw(1e-3)
    jstate = jtrain.TrainState(jp, jopt.init(jp), jnp.asarray(5, jnp.int32))
    JaxCheckpoints(str(tmp_path / "jax")).save(5, jstate, blocking=True)
    opt = optim.adamw(1e-3)
    params = snn.init_fc_snn(1, IMDB)
    like = TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32))
    step, state = CheckpointManager(str(tmp_path / "jax")).restore(like=like)
    assert step == 5 and isinstance(state, TrainState)
    got, want = tree_leaves(state), jax.tree_util.tree_leaves(jstate)
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    CheckpointManager(str(tmp_path / "port")).save(5, state, blocking=True)
    _, back = JaxCheckpoints(str(tmp_path / "port")).restore(like=jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the loop and the launcher
# ---------------------------------------------------------------------------

def loop_pair():
    """The port's and the JAX package's AdamW train steps of the IMDB SNN
    (JAX's initial parameters on both sides), their fresh states, and
    each side's loader factory over the same `sentiment_batch` stream
    (batch s from seed s, 8 reviews of 2 words)."""
    jp, _, _ = sentiment_case()
    ds = synthetic.make_sentiment_vocab(0)
    opt = optim.adamw(lambda s: 5e-3, weight_decay=0.0)
    jopt = joptim.adamw(lambda s: 5e-3, weight_decay=0.0)
    step = make_train_step(run_cfg(), opt, lambda p, b: snn.sentiment_loss(
        p, b["x"], b["y"], IMDB, device="cpu"))
    jstep = jtrain.make_train_step(
        run_cfg(jax_side=True), jopt,
        lambda p, b: jsnn.sentiment_loss(p, b["x"], b["y"], JAX_IMDB))
    state, jstate = snn_states(jp, opt, jopt)

    def batch_fn(s, shard_id, num_shards):
        return dict(zip(("x", "y"), synthetic.sentiment_batch(ds, 8, 2,
                                                              seed=s)))
    return (step, state, lambda: loader.ShardedLoader(batch_fn),
            jstep, jstate, lambda: jloader.ShardedLoader(batch_fn))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_loops_agree(res, jres, ckpt_dir=None):
    """The port's `LoopResult` against the JAX loop's on the same steps:
    resume point, preemption, final step, the steps and losses of the
    logged metrics, the checkpoint steps on disk and the parameters
    (within 1e-5 absolute, as in `test_snn_adamw_steps_match_jax`)."""
    assert res.resumed_from == jres.resumed_from
    assert res.preempted == jres.preempted
    assert int(res.state.step) == int(jres.state.step)
    assert [m["step"] for m in res.metrics_history] == [
        m["step"] for m in jres.metrics_history]
    for m, jm in zip(res.metrics_history, jres.metrics_history):
        assert m["loss"] == pytest.approx(jm["loss"], rel=LOSS_RTOL)
    if ckpt_dir is not None:
        assert CheckpointManager(str(ckpt_dir / "port")).all_steps() == \
            JaxCheckpoints(str(ckpt_dir / "jax")).all_steps()
    assert_trees_close(res.state.params, jres.state.params, rtol=0,
                       atol=1e-5)


def test_train_loop_restart_resumes_exactly(tmp_path):
    """Both loops stopped after 4 steps and restarted to 7 from a fresh
    state (checkpoint every 2, keep 3, log every 3): they resume from the
    same step, log and checkpoint the same steps and end with the same
    parameters; the port's resumed run equals its uninterrupted one bit for
    bit."""
    step, state, mk_loader, jstep, jstate, mk_jloader = loop_pair()

    def cfg(side, total):
        return LoopConfig(total_steps=total, ckpt_every=2, log_every=3,
                          ckpt_dir=str(tmp_path / side))

    def jcfg(side, total):
        return jloop.LoopConfig(total_steps=total, ckpt_every=2, log_every=3,
                                ckpt_dir=str(tmp_path / side))
    r1 = train_loop(step, state, mk_loader(), cfg("port", 4))
    j1 = jloop.train_loop(jstep, jstate, mk_jloader(), jcfg("jax", 4),
                          device_put_fn=jax_batch)
    assert r1.resumed_from is None and int(r1.state.step) == 4
    assert_loops_agree(r1, j1, tmp_path)
    r2 = train_loop(step, state, mk_loader(), cfg("port", 7))
    j2 = jloop.train_loop(jstep, jstate, mk_jloader(), jcfg("jax", 7),
                          device_put_fn=jax_batch)
    assert r2.resumed_from == 4 and int(r2.state.step) == 7
    assert_loops_agree(r2, j2, tmp_path)
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == [4, 6, 7]
    whole = train_loop(step, state, mk_loader(), LoopConfig(total_steps=7,
                                                            log_every=1))
    for a, b in zip(tree_leaves(r2.state.params),
                    tree_leaves(whole.state.params)):
        assert torch.equal(a, b)


def test_train_loop_checkpoints_and_exits_on_sigterm(tmp_path):
    """SIGTERM arrives during step 3 of 10 in both loops: each finishes the
    step, writes one blocking checkpoint and stops, with the same step,
    metrics, checkpoints and parameters; the handler is put back."""
    step, state, mk_loader, jstep, jstate, mk_jloader = loop_pair()

    def preempting(train_step):
        def wrapped(st, batch):
            if int(st.step) == 2:              # SIGTERM arrives in step 3
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return train_step(st, batch)
        return wrapped

    before = signal.getsignal(signal.SIGTERM)
    res = train_loop(preempting(step), state, mk_loader(),
                     LoopConfig(total_steps=10, ckpt_every=100, log_every=2,
                                ckpt_dir=str(tmp_path / "port")))
    assert signal.getsignal(signal.SIGTERM) is before
    jres = jloop.train_loop(preempting(jstep), jstate, mk_jloader(),
                            jloop.LoopConfig(total_steps=10, ckpt_every=100,
                                             log_every=2,
                                             ckpt_dir=str(tmp_path / "jax")),
                            device_put_fn=jax_batch)
    assert signal.getsignal(signal.SIGTERM) is before
    assert res.preempted and int(res.state.step) == 3
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == [3]
    assert_loops_agree(res, jres, tmp_path)


def test_train_snn_launcher_on_the_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "2", "--batch", "8", "--words",
            "2", "--trace", "--ckpt-dir", str(tmp_path)]
    acc_f, acc_i = train_snn.main(args)
    out = capsys.readouterr().out
    assert 0.0 <= acc_f <= 1.0 and 0.0 <= acc_i <= 1.0
    for text in ("trainable params: 29312", "eval accuracy", "agreement",
                 "Fig.11a", "pJ/inference", "Fig.10"):
        assert text in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    train_snn.main(args[:3] + ["3"] + args[4:])
    assert "resumed from step 2" in capsys.readouterr().out
