"""Language-model training in the port (`lm.loss_fn` with remat and vocab
chunking, `init_train_state`, the default `make_train_step`, the loop and
`launch/train.py`) against the JAX package's, on the CPU.

Models: `reduced_config` of llama3.2-1b (tied embeddings: the embedding's
gradient is the sum of the lookup's and the head's on both sides), of
rwkv6-7b (its wkv recurrence through the differentiable chunked form, at
seq 32 and so padded to the chunk of 64 on both sides) and the llama3.2-1b
variant with the spiking FFN (RMP, 8 steps, threshold 0.5, as in
`examples/spiking_ffn_lm.py`). Float32 parameters drawn by JAX are carried
across with `lm.params_from_jax`, and both sides see the same
`lm_batch_fn` batch. Tolerances: the loss and its ``ce`` within 1e-5
relative, every gradient leaf within 1e-4 relative L2 (float32 products in
XLA's order on one side and another BLAS's on the other), parameters after
one AdamW step within 1e-5 absolute (an update is lr-sized, 5e-4);
vocab chunking against the whole head within 1e-6; remat equal bit for bit.
"""
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import train_state as jtrain  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (MoEConfig, ParallelConfig,  # noqa: E402
                                      RunConfig, ShapeConfig, SpikingConfig,
                                      SSMConfig, get_config, reduced_config)
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data import loader  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import (LoopConfig, TrainState,  # noqa: E402
                               init_train_state, make_train_step, train_loop)
from repro_torch.train import train_state  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths,  # noqa: E402
                               tree_leaves, tree_unflatten_like)

LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
STEP_ATOL = 1e-5
CHUNK_RTOL = 1e-6
SPIKING = dict(neuron="rmp", timesteps=8, threshold=0.5)
MODELS = ("llama3.2", "rwkv", "spiking")
B, SEQ = 4, 32


def configs(name: str):
    """(JAX config, port config) of a test model."""
    arch = "rwkv6-7b" if name == "rwkv" else "llama3.2-1b"
    jcfg = jbase.reduced_config(jbase.get_config(arch))
    cfg = reduced_config(get_config(arch))
    if name == "spiking":
        jcfg = dataclasses.replace(jcfg, spiking=jbase.SpikingConfig(**SPIKING))
        cfg = dataclasses.replace(cfg, spiking=SpikingConfig(**SPIKING))
    return jcfg, cfg


_PARAMS: dict = {}


def params(name: str):
    """JAX float32 params (PRNGKey(0)) of a test model and the port's copy."""
    if name not in _PARAMS:
        jcfg, _ = configs(name)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        _PARAMS[name] = (jp, lm.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return _PARAMS[name]


def batch(seed: int = 0, step: int = 0, b: int = B, seq: int = SEQ):
    return loader.lm_batch_fn(512, b, seq, seed)(step, 0, 1)


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_parallel(**kw):
    return jbase.ParallelConfig(remat="none", fsdp=False, seq_parallel=False,
                                **kw)


def port_grads(p, b, cfg, parallel):
    """(loss, aux, [(path, grad)]) of `lm.loss_fn` by autograd."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    loss, aux = lm.loss_fn(tree_unflatten_like(p, leaves), b, cfg, parallel)
    grads = torch.autograd.grad(loss, leaves)
    paths = [path for path, _ in tree_flatten_with_paths(p)]
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, list(zip(paths, grads))


def rel_l2(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def assert_grads_match_jax(grads, jgrads):
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    worst = {}
    for (path, g), jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape, path
        worst["/".join(map(str, path))] = rel_l2(g, jg)
    bad = {k: v for k, v in worst.items() if not v <= GRAD_RL2}
    assert not bad, bad


# -- loss and gradients against JAX -------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_loss_and_gradients_match_jax(name):
    """`lm.loss_fn`'s loss, ``ce`` and ``aux`` and every gradient leaf
    against `jax.value_and_grad` of the JAX `lm.loss_fn` (remat off on both
    sides; the port's default remat is held against it below)."""
    jcfg, cfg = configs(name)
    jp, p = params(name)
    b = batch()
    (jloss, jaux), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jax_batch(b), jcfg, jax_parallel())
    loss, aux, grads = port_grads(p, b, cfg, ParallelConfig(remat="none"))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(aux["ce"]) == pytest.approx(float(jaux["ce"]), rel=LOSS_RTOL)
    assert float(aux["aux"]) == pytest.approx(float(jaux["aux"]),
                                              rel=LOSS_RTOL, abs=1e-7)
    assert (float(aux["aux"]) > 0) == (name == "spiking")
    assert_grads_match_jax(grads, jgrads)


def recording(run_network, store: list):
    """``run_network`` that also collects the rasters of each call into
    ``store`` (the spiking FFN's hidden populations, layer by layer)."""
    def call(*args, **kw):
        res = run_network(*args, **dict(kw, collect_rasters=True))
        store.append([np.asarray(r) for r in res.rasters])
        return res
    return call


def test_spiking_hidden_spikes_equal_jax(monkeypatch):
    """The loss's hidden spikes, layer by layer and step by step: the
    port's float executor against the JAX package's on the same current.
    It states how many of the raster's sites differ: none."""
    jcfg, cfg = configs("spiking")
    jp, p = params("spiking")
    b = batch()
    jseen, seen = [], []
    monkeypatch.setattr(jpipeline, "run_network",
                        recording(jpipeline.run_network, jseen))
    monkeypatch.setattr(pipeline, "run_network",
                        recording(pipeline.run_network, seen))
    jlm.loss_fn(jp, jax_batch(b), jcfg, jax_parallel(scan_layers=False))
    with torch.no_grad():
        lm.loss_fn(p, b, cfg, ParallelConfig(remat="none"))
    assert len(seen) == len(jseen) == cfg.n_layers
    sites = differ = 0
    for got, want in zip(seen, jseen):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            sites += g.size
            differ += int((g != w).sum())
    assert sites == cfg.n_layers * SPIKING["timesteps"] * B * SEQ * cfg.d_ff
    assert differ == 0, f"{differ} of {sites} hidden spike sites differ"


def test_spiking_rate_reaches_aux_with_its_gradient():
    """aux sums the spiking FFNs' rates, and its gradient reaches every
    layer's up projection through the surrogate spike, finite and
    non-zero; a layer's down projection reaches only the later layers'
    rates, so the last layer's gets none."""
    _, cfg = configs("spiking")
    _, p = params("spiking")
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    tree = tree_unflatten_like(p, leaves)
    _, aux = lm.loss_fn(tree, batch(), cfg, ParallelConfig(remat="none"))
    ffn = tree["blocks"]["pos0"]["ffn"]
    g_up, g_down = torch.autograd.grad(aux["aux"], [ffn["up"], ffn["down"]])
    assert torch.isfinite(g_up).all() and torch.isfinite(g_down).all()
    assert all(g.abs().sum() > 0 for g in g_up)
    assert g_down[0].abs().sum() > 0 and not g_down[-1].any()


def test_rwkv_loss_overflows_at_jax_chunk_and_not_at_16(monkeypatch):
    """The reference's arithmetic: at seq 64 (one whole chunk of JAX's 64)
    the JAX package's RWKV loss from its own initial weights is not finite
    (the chunked wkv6's exp(-L) passes float32's range), and the port's at
    its default ``wkv_chunk`` of 64 neither. At ``wkv_chunk=16`` the port's
    loss is finite and equals the loss through the sequential form (the
    wkv6 wrapper's default route on the CPU) within 1e-5."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import rwkv
    jcfg, cfg = configs("rwkv")
    jp, p = params("rwkv")
    b = batch(seq=64)
    jloss, _ = jlm.loss_fn(jp, jax_batch(b), jcfg, jax_parallel())
    assert not np.isfinite(float(jloss))
    with torch.no_grad():
        at64, _ = lm.loss_fn(p, b, cfg, ParallelConfig(remat="none"))
        at16, _ = lm.loss_fn(p, b, cfg, ParallelConfig(remat="none",
                                                       wkv_chunk=16))
        monkeypatch.setattr(rwkv, "wkv6", lambda *a, use_kernel, chunk, **k:
                            wkv_ops.wkv6(*a, **k))
        seq, _ = lm.loss_fn(p, b, cfg, ParallelConfig(remat="none"))
    assert not torch.isfinite(at64)
    assert torch.isfinite(at16)
    assert float(at16) == pytest.approx(float(seq), rel=LOSS_RTOL)


@pytest.mark.parametrize("name", ["llama3.2", "rwkv"])
def test_vocab_chunking_matches_the_whole_head_and_jax(name):
    """``vocab_chunking=4``: the loss and gradients within 1e-6 of the
    unchunked head's, and the loss within 1e-5 of the JAX package's
    chunked loss; a count that does not divide T raises as in JAX."""
    jcfg, cfg = configs(name)
    jp, p = params(name)
    b = batch()
    loss0, _, g0 = port_grads(p, b, cfg, ParallelConfig(remat="none"))
    loss4, _, g4 = port_grads(p, b, cfg, ParallelConfig(remat="none",
                                                        vocab_chunking=4))
    assert float(loss4) == pytest.approx(float(loss0), rel=CHUNK_RTOL)
    for (path, a), (_, c) in zip(g4, g0):
        assert rel_l2(a, c.numpy()) <= CHUNK_RTOL, path
    jloss, _ = jlm.loss_fn(jp, jax_batch(b), jcfg,
                           jax_parallel(vocab_chunking=4))
    assert float(loss4) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="vocab_chunking=3 must divide"):
        lm.loss_fn(p, b, cfg, ParallelConfig(vocab_chunking=3))
    with pytest.raises(ValueError, match="vocab_chunking=3 must divide"):
        jlm.loss_fn(jp, jax_batch(b), jcfg, jax_parallel(vocab_chunking=3))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("remat", ["block", "full"])
def test_remat_equals_no_remat_bit_for_bit(name, remat):
    """Recomputing each super-block in the backward pass changes no bit
    of the loss or of any gradient."""
    _, cfg = configs(name)
    _, p = params(name)
    b = batch(seed=1)
    loss_n, aux_n, g_n = port_grads(p, b, cfg, ParallelConfig(remat="none"))
    loss_r, aux_r, g_r = port_grads(p, b, cfg, ParallelConfig(remat=remat))
    assert torch.equal(loss_r, loss_n)
    assert torch.equal(aux_r["aux"], aux_n["aux"])
    for (path, a), (_, c) in zip(g_r, g_n):
        assert torch.equal(a, c), path


def test_remat_recomputes_each_super_block(monkeypatch):
    """With remat each super-block runs twice in a train step (forward,
    then again in the backward pass), without it once; serving paths
    (no grad) never recompute."""
    _, cfg = configs("llama3.2")
    _, p = params("llama3.2")
    calls = []
    orig = lm._apply_block

    def counting(*args, **kw):
        calls.append(kw.get("train"))
        return orig(*args, **kw)
    monkeypatch.setattr(lm, "_apply_block", counting)
    for remat, want in (("none", cfg.n_layers), ("block", 2 * cfg.n_layers)):
        calls.clear()
        port_grads(p, batch(), cfg, ParallelConfig(remat=remat))
        assert len(calls) == want and all(calls)
    calls.clear()
    with torch.no_grad():
        lm.prefill(p, {"tokens": torch.as_tensor(batch()["tokens"])}, cfg, 64)
    assert len(calls) == cfg.n_layers and not any(calls)


def test_loss_fn_refuses_the_other_families_by_name():
    """A family the JAX package's lm does not model is refused by name; a
    MoE stack with Mamba layers (jamba style) without an SSM config raises
    the JAX package's `ValueError`, and with one (a hybrid) its loss is
    finite and reaches the Mamba layer's weights; an encoder-decoder
    (audio) stack's loss over stub frames is finite and reaches its
    encoder and cross-attention weights, and a vision-stub (vlm) stack's
    over patches ahead of the tokens is finite and moves with the
    patches."""
    _, cfg = configs("llama3.2")
    _, p = params("llama3.2")
    mamba_moe = dict(attn_layer_period=2, moe=MoEConfig(
        n_experts=4, top_k=1, d_ff=64, every=2))
    rng = np.random.default_rng(0)
    for family in ("moe", "hybrid", "audio", "vlm", "snn"):
        kw = {"moe": mamba_moe,
              "hybrid": dict(mamba_moe, ssm=SSMConfig(d_state=8, dt_rank=16)),
              "audio": dict(is_encoder_decoder=True, n_encoder_layers=2,
                            frontend="audio_stub"),
              "vlm": dict(frontend="vision_stub")}.get(family, {})
        other = dataclasses.replace(
            cfg, arch_id=f"{family}-like", family=family, **kw)
        if family in ("hybrid", "audio", "vlm"):
            hp = lm.init_params(0, other, dtype=torch.float32, device="cpu")
            b = batch()
            if family == "hybrid":
                ws = [hp["blocks"]["pos1"]["ssm"]["in_proj"]]
            elif family == "audio":
                b["frames"] = rng.standard_normal((B, 12, 128)).astype(
                    np.float32)
                ws = [hp["encoder"]["blocks"]["attn"]["wq"],
                      hp["blocks"]["pos0"]["cross"]["wk"]]
            else:
                b["patches"] = rng.standard_normal((B, 4, 128)).astype(
                    np.float32)
                ws = [hp["embed"]]
            ws = [w.requires_grad_(True) for w in ws]
            loss, _ = lm.loss_fn(hp, b, other)
            assert torch.isfinite(loss)
            grads = torch.autograd.grad(loss, ws)
            assert all(float(g.abs().sum()) > 0 for g in grads)
            if family == "vlm":     # the text attends the patches
                text_only, _ = lm.loss_fn(hp, batch(), other)
                assert float(text_only) != float(loss)
        elif family == "moe":
            with pytest.raises(ValueError, match="cfg.ssm is unset"):
                lm.loss_fn(p, batch(), other)
        else:
            with pytest.raises(NotImplementedError, match=f"'{family}'"):
                lm.loss_fn(p, batch(), other)


# -- the train state and step -------------------------------------------------

def tiny_run(name: str, jax_side: bool = False, **parallel):
    """test_substrate's `_tiny_run` for a test model: B = 4, seq 32, AdamW
    at lr 1e-3 with a warm-up of 2 steps, remat off."""
    jcfg, cfg = configs(name)
    if jax_side:
        return jbase.RunConfig(model=jcfg,
                               shape=jbase.ShapeConfig("t", SEQ, B, "train"),
                               parallel=jax_parallel(**parallel),
                               optimizer="adamw", learning_rate=1e-3,
                               warmup_steps=2)
    return RunConfig(model=cfg, shape=ShapeConfig("t", SEQ, B, "train"),
                     parallel=ParallelConfig(remat="none", **parallel),
                     optimizer="adamw", learning_rate=1e-3, warmup_steps=2)


def jax_state(name: str, total_steps: int = 8):
    jrun = tiny_run(name, jax_side=True)
    return jtrain.init_train_state(jax.random.PRNGKey(0), jrun,
                                   total_steps=total_steps, dtype=jnp.float32)


def port_state(jstate, run, total_steps: int = 8):
    """The JAX state's parameters carried across, with the port's own
    optimizer (`_make_opt`, as `init_train_state` builds it) and state."""
    opt = train_state._make_opt(run, total_steps)
    p = lm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params), device="cpu")
    return TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32)), opt


def assert_params_close(got, want, atol=STEP_ATOL):
    for (path, a), b in zip(tree_flatten_with_paths(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol, err_msg=str(path))


ADAM_G_MIN = 1e-7      # clipped |g| above which the first step is stable
ADAM_STABLE_SHARE = 0.85   # least share of parameters held at 1e-5


@pytest.mark.parametrize("name", MODELS)
def test_adamw_step_matches_jax(name):
    """One step of the default train step (`lm.loss_fn`, clip at 1.0,
    AdamW with the cosine warm-up) on both sides: loss, gradient norm and
    every parameter after the step within 1e-5 absolute.

    Adam's first update is lr * g / (|g| + eps) with eps = 1e-8, whose
    slope lr * eps / (|g| + eps)^2 reaches lr / eps = 5e4 at g = 0: an
    element whose gradient is within float32 noise of 0 on both sides (a
    1e-10 difference, inside the 1e-4 relative L2 of its leaf) can move by
    up to 2 lr there. So the 1e-5 holds where JAX's clipped |g| is at least
    1e-7; below it each element is held within the step's bound 2 lr.
    The elements held at 1e-5 must be at least 85 % of all parameters
    (the count is stated on failure; below 1e-7: 100 of 361,088 for
    llama3.2, 54 of 295,552 with the spiking FFN, 56,415 of 576,640 for
    rwkv, whose gradient norm of 38 the clip divides out)."""
    jcfg, _ = configs(name)
    jstate, jopt = jax_state(name)
    run = tiny_run(name)
    state, opt = port_state(jstate, run)
    b = batch()
    new, m = make_train_step(run, opt)(state, b)
    jnew, jm = jax.jit(jtrain.make_train_step(tiny_run(name, True), jopt))(
        jstate, jax_batch(b))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GRAD_RL2)
    assert int(new.step) == int(jnew.step) == 1
    _, jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jstate.params, jax_batch(b), jcfg, jax_parallel())
    clip = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    lr_1 = 1e-3 * 1 / 2                       # step 1 of the warm-up
    ill = total = 0
    for (path, a), c, g in zip(tree_flatten_with_paths(new.params),
                               jax.tree_util.tree_leaves(jnew.params),
                               jax.tree_util.tree_leaves(jgrads)):
        d = np.abs(a.numpy() - np.asarray(c, np.float32))
        stable = np.abs(np.asarray(g)) * clip >= ADAM_G_MIN
        assert (d[stable] <= STEP_ATOL).all(), (path, d[stable].max())
        assert (d <= 2 * lr_1).all(), (path, d.max())
        ill += int((~stable).sum())
        total += d.size
    assert ill <= (1 - ADAM_STABLE_SHARE) * total, \
        f"{ill} of {total} parameters below a clipped |g| of 1e-7"


@pytest.mark.parametrize("name", MODELS)
def test_init_train_state_and_the_default_step(name):
    """`init_train_state` draws `lm.init_params`' weights with the run's
    optimizer state at step 0, and `make_train_step` without a loss takes
    `lm.loss_fn` under the run's parallel config."""
    _, cfg = configs(name)
    run = tiny_run(name)
    state, opt = init_train_state(0, run, total_steps=8, dtype=torch.float32,
                                  device="cpu")
    want = lm.init_params(0, cfg, dtype=torch.float32, device="cpu")
    for a, c in zip(tree_leaves(state.params), tree_leaves(want)):
        assert torch.equal(a, c)
    assert int(state.step) == 0 and int(state.opt_state["step"]) == 0
    assert all(not x.any() for x in tree_leaves(state.opt_state["m"]))
    b = batch()
    _, m = make_train_step(run, opt)(state, b)
    with torch.no_grad():
        loss, _ = lm.loss_fn(state.params, b, cfg, run.parallel)
    assert torch.equal(m["loss"], loss)


def test_microbatches_match_the_full_batch_and_jax():
    """Two microbatches of 2 against one batch of 4 at test_substrate's
    tolerances (loss within 2e-2, the first leaf within 5e-2), and the
    port's two microbatches against the JAX package's within this file's
    step tolerances."""
    name = "llama3.2"
    jstate, jopt = jax_state(name)
    b = batch()
    runs = {mb: tiny_run(name, microbatches=mb) for mb in (1, 2)}
    out = {}
    for mb, run in runs.items():
        state, opt = port_state(jstate, run)
        out[mb] = make_train_step(run, opt)(state, b)
    (s1, m1), (s2, m2) = out[1], out[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-2)
    np.testing.assert_allclose(tree_leaves(s1.params)[0].numpy(),
                               tree_leaves(s2.params)[0].numpy(), atol=5e-2)
    jnew, jm = jax.jit(jtrain.make_train_step(
        tiny_run(name, True, microbatches=2), jopt))(jstate, jax_batch(b))
    assert float(m2["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert_params_close(s2.params, jnew.params)


def test_train_loop_restarts_through_the_jax_checkpoint_format(tmp_path):
    """test_substrate's restart, in the port (bf16 weights, as
    `init_train_state` draws them): 4 steps with a checkpoint every 2,
    then a fresh state resumes from step 4 and runs to 6; the JAX
    `CheckpointManager` restores the port's last checkpoint into a JAX
    train state, leaf for leaf, and the port restores a JAX-written LM
    train state."""
    run = RunConfig(model=configs("llama3.2")[1],
                    shape=ShapeConfig("t", SEQ, B, "train"),
                    parallel=ParallelConfig(remat="none"),
                    optimizer="adamw", learning_rate=1e-3, warmup_steps=2)
    state, opt = init_train_state(0, run, total_steps=8, device="cpu")
    step_fn = make_train_step(run, opt)
    fn = loader.lm_batch_fn(512, B, SEQ, seed=0)

    def mk_loader():
        return loader.ShardedLoader(fn)
    r1 = train_loop(step_fn, state, mk_loader(),
                    LoopConfig(total_steps=4, ckpt_every=2,
                               ckpt_dir=str(tmp_path), log_every=1))
    assert int(r1.state.step) == 4
    state2, _ = init_train_state(0, run, total_steps=8, device="cpu")
    r2 = train_loop(step_fn, state2, mk_loader(),
                    LoopConfig(total_steps=6, ckpt_every=2,
                               ckpt_dir=str(tmp_path), log_every=1))
    assert r2.resumed_from == 4 and int(r2.state.step) == 6
    assert [int(m["step"]) for m in r2.metrics_history] == [5, 6]

    jstate, _ = jtrain.init_train_state(jax.random.PRNGKey(0),
                                        tiny_run("llama3.2", True),
                                        total_steps=8)
    step, back = JaxCheckpoints(str(tmp_path)).restore(like=jstate)
    assert step == 6
    got = jax.tree_util.tree_leaves(back)
    want = tree_leaves(r2.state)
    assert len(got) == len(want)
    for a, c in zip(got, want):
        assert np.asarray(a).dtype.name == str(c.dtype).split(".")[-1]
        np.testing.assert_array_equal(
            np.asarray(a, np.float32), c.float().numpy())
    JaxCheckpoints(str(tmp_path / "jax")).save(0, jstate, blocking=True)
    step, restored = CheckpointManager(str(tmp_path / "jax")).restore(
        like=state2)
    assert step == 0 and isinstance(restored, TrainState)
    for a, c in zip(tree_leaves(restored), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(c, np.float32))


def test_train_loss_decreases():
    """test_substrate's check in the port: 20 steps of the reduced
    llama3.2-1b (bf16, AdamW at 1e-3) lower the mean of the last 5 losses
    below the first 5's by more than 0.1."""
    run = RunConfig(model=configs("llama3.2")[1],
                    shape=ShapeConfig("t", SEQ, B, "train"),
                    parallel=ParallelConfig(remat="none"),
                    optimizer="adamw", learning_rate=1e-3, warmup_steps=2)
    state, opt = init_train_state(0, run, total_steps=30, device="cpu")
    step_fn = make_train_step(run, opt)
    fn = loader.lm_batch_fn(512, B, SEQ, seed=0)
    losses = []
    for s in range(20):
        state, m = step_fn(state, fn(s, 0, 1))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_loader_batches_equal_jax():
    for s in (0, 5):
        for k, v in batch(step=s).items():
            np.testing.assert_array_equal(
                v, jloader.lm_batch_fn(512, B, SEQ, 0)(s, 0, 1)[k])


# -- the launcher -------------------------------------------------------------

def argument_lines(fn) -> list:
    return [line.strip() for line in inspect.getsource(fn).splitlines()
            if line.strip().startswith("ap.add_argument(")]


def test_launcher_flags_are_the_jax_launchers():
    """The port's flags are the JAX launcher's, word for word, plus
    ``--device``; and JAX's quirk is kept: ``--reduced`` is a store_true
    flag whose default is already True, so the reduced config always
    trains."""
    port = argument_lines(launch.build_parser)
    assert port[:-1] == argument_lines(jlaunch.main)
    assert port[-1] == 'ap.add_argument("--device", default="cuda")'
    args = launch.build_parser().parse_args(["--arch", "llama3.2-1b"])
    assert args.reduced is True and args.device == "cuda"
    assert launch.build_parser().parse_args(
        ["--arch", "x", "--reduced"]).reduced is True


def test_launcher_trains_the_reduced_config_on_the_cpu(capsys, tmp_path):
    res = launch.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--steps", "5", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert res.state.params["embed"].shape == (512, 128)
    assert res.state.params["embed"].dtype == torch.bfloat16
    assert [line.split(" loss ")[0] for line in out[:2]] == ["step 1",
                                                             "step 5"]
    assert all(" gnorm " in line and line.endswith("s") for line in out[:2])
    assert out[2] == "done: 2 logs, resumed_from=None, stragglers=0"
    assert CheckpointManager(str(tmp_path)).all_steps() == [5]
    launch.main(["--arch", "llama3.2-1b", "--device", "cpu", "--steps", "6",
                 "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert "resumed_from=5" in capsys.readouterr().out
