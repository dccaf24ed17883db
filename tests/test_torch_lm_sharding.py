"""The port's LM sharding on `torch.distributed`: placements equal to the
JAX package's, and placements that move values between ranks without
changing them.

* Specs: `param_specs`, `batch_specs`, `cache_specs` and `logits_spec` on a
  (2, 2) dict mesh, leaf by leaf against JAX's ``PartitionSpec``s on its
  (2, 2) host mesh (conftest's 4 forced devices), translated to one
  placement per mesh axis; JAX's `_fit` cases and a drop that degrades
  with a log line.
* One world of 4 gloo ranks on the CPU (`tests/torch_lm_sharding_worker.py`,
  started once for the file by the module fixture, a `FileStore` under
  ``tmp_path``, ``OMP_NUM_THREADS=1``; the ranks import no JAX) runs the
  sharded train step, the elastic checkpoint restore, the MoE and Mamba
  blocks and the experts' products with their gradients under
  `activation_rules`, the serving models' prefill and decode steps on
  (2, 2) and (1, 4) with their caches, the head-local blocks (attention,
  MLA and RWKV's time mix, each model rank on its own heads) with their
  gradients and the flops of their score products, `compressed_psum_mean`
  and GPipe.
* The JAX oracles of the world's cases (the sharded train step of
  `tests/test_distribution.py` on (2, 2), `compressed_psum_mean` on 4
  shards, `make_pipeline_fn` on 4 stages) run in one subprocess with 4
  forced host devices, beside the world.

Float32 parameters everywhere. A sharded float32 product sums in another
order, so the train step is held to the AdamW rule of the port's train
tests: losses and gradient norms within 1e-5 relative, every parameter
within 1e-5 where the clipped |g| is at least 1e-7 at both steps and
within 2 lr a step elsewhere, the first kind at least 85 % of all.
"""
import dataclasses
import logging
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import (ParallelConfig, RunConfig, ShapeConfig,
                                      get_config, reduced_config)
from repro_torch.dist import sharding
from repro_torch.models import io_spec, layers, lm, mamba
from repro_torch.optim import make_optimizer
from repro_torch.train.train_state import TrainState, make_train_step
from repro_torch.tree import tree_flatten_with_paths, tree_leaves
from torch_lm_sharding_worker import HEAD_BLOCKS, run_head_block

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESH22 = {"data": 2, "model": 2}
SHAPE = ShapeConfig("t", 64, 8, "train")
PARALLEL = ParallelConfig(remat="block", fsdp=True, seq_parallel=True,
                          vocab_chunking=2)
BLOCK_PARALLEL = ParallelConfig(moe_constraints=True, state_constraints=True)
LR = 1e-3
LOSS_RTOL = 1e-5
STEP_ATOL = 1e-5
ADAM_G_MIN = 1e-7
ADAM_STABLE_SHARE = 0.85
BLOCK_RTOL = 1e-5          # float32 rounding of a resharded block
SERVE_LOGIT_RTOL = 1e-4    # float32 logits after a bf16 cache
BF16_RTOL = 2.0 ** -7      # one bf16 rounding of a cache leaf's value
ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
#: serving: GQA attention, MLA with its prelude and MoE, RWKV
SERVE_ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b", "rwkv6-7b")
SERVE_PARALLEL = ParallelConfig()            # the dry-run's DEFAULT_SERVE
SERVE_B, SERVE_T, SERVE_MAX_LEN, SERVE_STEPS = 4, 8, 16, 2


# ---------------------------------------------------------------------------
# JAX placements, translated
# ---------------------------------------------------------------------------

def to_placements(spec, axes=("data", "model")) -> tuple:
    """A JAX PartitionSpec as one placement per mesh axis."""
    out = []
    for axis in axes:
        dims = [i for i, p in enumerate(spec)
                if p == axis or (isinstance(p, tuple) and axis in p)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def jax_mesh22():
    from repro.launch.mesh import make_host_mesh
    return make_host_mesh(4, model=2)


def jax_parallel(fsdp=True, seq_parallel=True):
    from repro.configs.base import ParallelConfig as JParallel
    return JParallel(fsdp=fsdp, seq_parallel=seq_parallel)


def jax_cfg(arch):
    from repro.configs.base import get_config as jget, reduced_config as jred
    return jred(jget(arch))


def spec_leaves(specs) -> list:
    """The placement tuples of a port spec tree, in leaf order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def assert_specs_equal(got, jax_tree):
    import jax
    want = jax.tree_util.tree_leaves(
        jax_tree, is_leaf=lambda x: hasattr(x, "spec"))
    got = spec_leaves(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == to_placements(w.spec), (i, g, w.spec)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, fsdp):
    """Every parameter leaf's placements on (2, 2) are JAX's
    `param_specs`, with FSDP on and off."""
    import jax
    from repro.dist import sharding as jsharding
    from repro.models import lm as jlm
    cfg = reduced_config(get_config(arch))
    params = lm.init_params(0, cfg, dtype=torch.float32, device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_params(
        jax.random.PRNGKey(0), jax_cfg(arch)))
    got = sharding.param_specs(params, MESH22, ParallelConfig(fsdp=fsdp))
    assert_specs_equal(got, jsharding.param_specs(
        shapes, jax_mesh22(), jax_parallel(fsdp=fsdp)))
    # tensor parallel on the last axis: the embedding's d, every stacked
    # kernel's output axis
    assert got["embed"][1] == Shard(1)


@pytest.mark.parametrize("seq_parallel", [True, False],
                         ids=["seq", "no_seq"])
@pytest.mark.parametrize("arch", ARCHS + ("whisper-large-v3",
                                          "llava-next-mistral-7b"))
def test_batch_specs_equal_jax(arch, seq_parallel):
    """A train batch's placements (tokens, targets, and frames or patches)
    are JAX's `batch_specs`: the batch over data and, under sequence
    parallelism, the sequence over model."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.dist import sharding as jsharding
    from repro.models import io_spec as jio
    cfg = reduced_config(get_config(arch))
    got = sharding.batch_specs(io_spec.train_batch_spec(cfg, SHAPE), MESH22,
                               ParallelConfig(seq_parallel=seq_parallel))
    want = jsharding.batch_specs(
        jio.train_batch_spec(jax_cfg(arch), JShape("t", 64, 8, "train")),
        jax_mesh22(), jax_parallel(seq_parallel=seq_parallel))
    assert_specs_equal(got, want)
    assert got["tokens"] == ((Shard(0), Shard(1)) if seq_parallel
                             else (Shard(0), Replicate()))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch):
    """`init_cache`'s tree (K/V, MLA latent, Mamba conv and state, the
    lengths) placed as JAX's `cache_specs`: batch over data, axis 2 over
    model where it divides."""
    import jax
    from repro.dist import sharding as jsharding
    from repro.models import lm as jlm
    cfg = reduced_config(get_config(arch))
    cache = lm.init_cache(cfg, 4, 16, device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_cache(jax_cfg(arch), 4, 16))
    assert_specs_equal(
        sharding.cache_specs(cache, MESH22, ParallelConfig()),
        jsharding.cache_specs(shapes, jax_mesh22(), jax_parallel()))


@pytest.mark.parametrize("shape", [(8, 512), (5, 512), (8, 6), (3, 7)])
def test_logits_spec_equal_jax(shape):
    from repro.dist import sharding as jsharding
    assert sharding.logits_spec(MESH22, shape) == to_placements(
        jsharding.logits_spec(jax_mesh22(), shape).spec)


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), (8, 12)),            # both divide
    (("data", "model"), (8, 10)),            # 10 % 4: model dropped
    ((("data", "model"), None), (16, 3)),    # one dim over both axes
])
def test_fit_cases_of_the_jax_tests(axes, shape):
    """`tests/test_distribution.py`'s `_fit` cases on a (2, 4) mesh."""
    from repro.dist import sharding as jsharding
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 4)))
    got = sharding._fit(axes, shape, {"data": 2, "model": 4})
    assert got == to_placements(jsharding._fit(axes, shape, fake))


def test_whisper_heads_drop_with_a_log_line(caplog):
    """whisper-large-v3's 20 heads on a {"data": 2, "model": 8} mesh: a
    head axis does not divide 8, so it replicates, logged with the
    extents, where JAX's `_fit` drops it on the same geometry (the
    (B, T, heads, D) activation and a layer's K/V cache); every leaf of
    the stacked cache is placed as JAX's rule places it, and the
    1,280-wide projections still shard."""
    from repro.dist import sharding as jsharding
    cfg = get_config("whisper-large-v3")
    mesh = {"data": 2, "model": 8}
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 8)))
    act = (4, 64, cfg.n_heads, cfg.head_dim)
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.dist.sharding"):
        heads = sharding.logical_spec(mesh, ("batch", None, "heads", None),
                                      act)
        entry = sharding.cache_specs(lm._cache_entry(
            cfg, 0, 4, 64, torch.float32, "meta"), mesh, ParallelConfig())
    assert heads == (Shard(0), Replicate()) == to_placements(
        jsharding.logical_spec(fake, ("batch", None, "heads", None), act))
    assert entry["k"] == entry["v"] == (Shard(0), Replicate())
    rendered = [r.getMessage() for r in caplog.records
                if r.name == "repro_torch.dist.sharding"]
    assert sum("size 20 does not divide mesh extent 8" in m
               for m in rendered) == 3
    cache = lm.init_cache(cfg, 4, 64, device="meta", enc_len=32)
    specs = sharding.cache_specs(cache, mesh, ParallelConfig())
    for (path, leaf), got in zip(tree_flatten_with_paths(cache),
                                 spec_leaves(specs)):
        prop = [None] * leaf.dim()
        if leaf.dim() >= 1:
            prop[0] = "data"
        if leaf.dim() >= 3:
            prop[2] = "model"
        assert got == to_placements(jsharding._fit(
            tuple(prop), tuple(leaf.shape), fake)), path
    params = lm.init_params(0, cfg, dtype=torch.float32, device="meta")
    wq = sharding.param_specs(params, mesh, ParallelConfig())[
        "blocks"]["pos0"]["attn"]["wq"]
    assert wq == (Shard(0), Shard(2))


def test_replicated_and_logical_sharding():
    assert sharding.replicated(MESH22) == (Replicate(), Replicate())
    assert sharding.logical_sharding(MESH22, ("batch", "vocab"), (8, 512)) \
        == (Shard(0), Shard(1))
    assert sharding.logical_sharding(MESH22, ("heads",), (6,)) \
        == (Replicate(), Shard(0))


def test_constrain_is_the_identity_outside_the_rules():
    """`constrain` returns its argument itself without active rules, and
    on a plain tensor inside them; the model's constraint sites therefore
    leave every single-device path as it was."""
    x = torch.randn(2, 4, 8)
    assert sharding.constrain(x, ("batch", "seq", None)) is x
    with sharding.activation_rules(MESH22, PARALLEL):
        assert sharding.constrain(x, ("batch", "seq", None)) is x
    assert sharding._RULES.mesh is None


def test_head_local_is_the_call_outside_the_rules():
    """`head_local` returns ``fn``'s own result without active rules, and
    on plain tensors inside them: the one-device path runs the same
    code."""
    q, k = torch.randn(2, 4, 4, 8), torch.randn(2, 4, 2, 8)
    marker = object()
    axes = (("batch", None, "heads", None), ("batch", None, "kv_heads", None))

    def fn(a, b):
        assert a is q and b is k
        return marker
    assert sharding.head_local(fn, (q, k), axes, axes[0]) is marker
    with sharding.activation_rules(MESH22, PARALLEL):
        assert sharding.head_local(fn, (q, k), axes, axes[0]) is marker


def test_meshless_mesh_has_no_device_mesh():
    """A mesh of extent 1 built without a process group has no DeviceMesh,
    and the LM placements refuse it by name; the production mesh needs
    its 256 ranks."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    mesh = make_mesh((1, 1), device_type="cpu")
    assert mesh.device_mesh is None
    with pytest.raises(ValueError, match="no DeviceMesh"):
        sharding.device_mesh_of(mesh)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


# ---------------------------------------------------------------------------
# the world and the JAX oracles
# ---------------------------------------------------------------------------

JAX_ORACLES = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs.base import (ParallelConfig, RunConfig, ShapeConfig,
                                get_config, reduced_config)
from repro.dist import sharding as shd
from repro.dist.compress import compressed_psum_mean
from repro.dist.pipeline import make_pipeline_fn
from repro.launch.mesh import make_mesh
from repro.models import io_spec, lm
from repro.optim import make_optimizer
from repro.train.train_state import TrainState, make_train_step

spec = np.load(sys.argv[1])
out = {}
cfg = reduced_config(get_config("llama3.2-1b"))
shape = ShapeConfig("t", 64, 8, "train")
parallel = ParallelConfig(remat="block", fsdp=True, seq_parallel=True,
                          vocab_chunking=2)
run = RunConfig(model=cfg, shape=shape, parallel=parallel,
                optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
mesh = make_mesh((2, 2), ("data", "model"))
opt = make_optimizer("adamw", 1e-3, 0.1)
with mesh:
    params = lm.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = treedef.unflatten([jnp.asarray(spec[f"p{i}"])
                                for i in range(len(leaves))])
    params = jax.tree_util.tree_map(jax.device_put, params,
                                    shd.param_specs(params, mesh, parallel))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    batch = io_spec.materialize(io_spec.train_batch_spec(cfg, shape))
    batch = jax.tree_util.tree_map(jax.device_put, batch,
                                   shd.batch_specs(batch, mesh, parallel))
    step_fn = jax.jit(make_train_step(run, opt))
    with shd.activation_rules(mesh, parallel):
        state, m1 = step_fn(state, batch)
        state, m2 = step_fn(state, batch)
out["losses"] = np.array([float(m1["loss"]), float(m2["loss"])])
out["grad_norms"] = np.array([float(m1["grad_norm"]),
                              float(m2["grad_norm"])])

mesh4 = make_mesh((4,), ("data",))
g = jnp.asarray(spec["compress_g"])

def cstep(g, r):
    o, r2 = compressed_psum_mean({"w": g[0]}, {"w": r[0]}, "data")
    return o["w"][None], r2["w"][None]

f = shard_map(cstep, mesh=mesh4, in_specs=(P("data"), P("data")),
              out_specs=(P("data"), P("data")), check_rep=False)
r = jnp.zeros_like(g)
means, residuals = [], []
for _ in range(6):
    o, r = f(g, r)
    means.append(np.asarray(o))
    residuals.append(np.asarray(r))
out["means"] = np.stack(means)
out["residuals"] = np.stack(residuals)

pmesh = make_mesh((4,), ("pipe",))
pipe = make_pipeline_fn(lambda w, x: jnp.tanh(x @ w), pmesh, "pipe",
                        n_micro=int(spec["pipe_xs"].shape[0]))
out["pipe"] = np.asarray(pipe(jnp.asarray(spec["pipe_ws"]),
                              jnp.asarray(spec["pipe_xs"])))
np.savez(sys.argv[2], **out)
"""


def head_blocks(rng, gen) -> dict:
    """The inputs of the worker's `HEAD_BLOCKS`, float32: each block's
    config, parameters and input x (B = 4, T = 16); ``rwkv_state`` also a
    carried token shift and wkv state."""
    from repro_torch.models import rwkv
    llama = reduced_config(get_config("llama3.2-1b"))
    mla = reduced_config(get_config("deepseek-v2-lite-16b"))
    rw = reduced_config(get_config("rwkv6-7b"))
    h6 = dataclasses.replace(llama, n_heads=6)
    tm = rwkv.init_rwkv_block(gen, rw, torch.float32)["tm"]

    def x(cfg):
        return torch.from_numpy(rng.standard_normal(
            (4, 16, cfg.d_model)).astype(np.float32))
    K = rw.rwkv.head_size
    return {
        "attention": {"cfg": llama, "x": x(llama),
                      "p": layers.init_attention(gen, llama, dtype=torch.float32)},
        "attention_h6": {"cfg": h6, "x": x(h6),
                         "p": layers.init_attention(gen, h6, dtype=torch.float32)},
        "mla": {"cfg": mla, "x": x(mla),
                "p": layers.init_mla(gen, mla, torch.float32)},
        "rwkv": {"cfg": rw, "x": x(rw), "p": tm},
        "rwkv_state": {
            "cfg": rw, "x": x(rw), "p": tm,
            "shift": torch.from_numpy(rng.standard_normal(
                (4, rw.d_model)).astype(np.float32)),
            "wkv": torch.from_numpy(rng.standard_normal(
                (4, rw.n_heads, K, K)).astype(np.float32))}}


class _Setup:
    """The inputs of every world case, built once for the file: the
    reduced llama3.2-1b's JAX parameters (float32) as numpy, the MoE and
    Mamba blocks with their inputs, the gradient rows and the stages."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.models import lm as jlm
        jparams = jlm.init_params(jax.random.PRNGKey(0),
                                  jax_cfg("llama3.2-1b"), dtype=jnp.float32)
        self.jparams_np = jax.tree_util.tree_map(np.asarray, jparams)
        self.cfg = reduced_config(get_config("llama3.2-1b"))
        rng = np.random.default_rng(0)
        gen = torch.Generator().manual_seed(0)
        self.moe_cfg = reduced_config(get_config("deepseek-v2-lite-16b"))
        self.moe_p = layers.init_moe(gen, self.moe_cfg, torch.float32)
        self.moe_x = torch.from_numpy(rng.standard_normal(
            (4, 8, self.moe_cfg.d_model)).astype(np.float32))
        self.mamba_cfg = reduced_config(get_config("jamba-v0.1-52b"))
        self.mamba_p = mamba.init_mamba_block(gen, self.mamba_cfg,
                                              torch.float32)
        self.mamba_x = torch.from_numpy(rng.standard_normal(
            (4, 40, self.mamba_cfg.d_model)).astype(np.float32))
        self.experts_x = torch.from_numpy(rng.standard_normal(
            (4, 4, 3, 8)).astype(np.float32))
        self.experts_w = torch.from_numpy(rng.standard_normal(
            (4, 8, 6)).astype(np.float32))
        self.serve = {}
        for arch in SERVE_ARCHS:
            cfg = reduced_config(get_config(arch))
            tokens = [torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (SERVE_B, t)).astype(np.int32))
                for t in (SERVE_T,) + (1,) * SERVE_STEPS]
            self.serve[arch] = {
                "cfg": cfg, "max_len": SERVE_MAX_LEN,
                "params": lm.init_params(0, cfg, dtype=torch.float32,
                                         device="cpu"),
                "prompt": tokens[0], "steps": tokens[1:]}
        self.heads = head_blocks(rng, gen)
        # tests/test_distribution.py's inputs, on 4 shards
        self.compress_g = np.random.default_rng(0).standard_normal(
            (WORLD, 64)).astype(np.float32)
        prng = np.random.default_rng(0)
        self.pipe_ws = (prng.standard_normal((4, 16, 16)) * 0.3).astype(
            np.float32)
        self.pipe_xs = prng.standard_normal((6, 2, 16)).astype(np.float32)

    def spec(self) -> dict:
        return {"params": self.jparams_np, "cfg": self.cfg, "shape": SHAPE,
                "parallel": PARALLEL, "block_parallel": BLOCK_PARALLEL,
                "moe_cfg": self.moe_cfg, "moe_p": self.moe_p,
                "moe_x": self.moe_x, "mamba_cfg": self.mamba_cfg,
                "mamba_p": self.mamba_p, "mamba_x": self.mamba_x,
                "experts_x": self.experts_x, "experts_w": self.experts_w,
                "serve": self.serve, "serve_parallel": SERVE_PARALLEL,
                "heads": self.heads,
                "compress_g": torch.from_numpy(self.compress_g),
                "pipe_ws": torch.from_numpy(self.pipe_ws),
                "pipe_xs": torch.from_numpy(self.pipe_xs)}

    def jax_inputs(self) -> dict:
        import jax
        flat = jax.tree_util.tree_leaves(self.jparams_np)
        return {**{f"p{i}": a for i, a in enumerate(flat)},
                "compress_g": self.compress_g, "pipe_ws": self.pipe_ws,
                "pipe_xs": self.pipe_xs}


@pytest.fixture(scope="module")
def setup():
    return _Setup()


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """Each rank's results and the JAX oracles: one gloo world of 4 ranks
    and one JAX subprocess for the file, run side by side."""
    d = tmp_path_factory.mktemp("lm_sharding_world")
    torch.save(setup.spec(), d / "spec.pt")
    np.savez(d / "jax_in.npz", **setup.jax_inputs())
    src = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(src))
    procs = []
    for rank in range(WORLD):
        log = open(d / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_lm_sharding_worker.py"),
             str(d / "spec.pt"), str(rank), str(WORLD), str(d / "store"),
             str(d)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    jax_env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
    jax_log = open(d / "jax.log", "w")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_ORACLES),
         str(d / "jax_in.npz"), str(d / "jax_out.npz")], env=jax_env,
        stdout=jax_log, stderr=subprocess.STDOUT)
    failed = []
    try:
        for rank, (p, _) in enumerate(procs):
            if p.wait(timeout=600) != 0:
                failed.append(f"rank{rank}")
        if jax_proc.wait(timeout=600) != 0:
            failed.append("jax")
    finally:
        for p, log in procs + [(jax_proc, jax_log)]:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        tail = (d / f"{failed[0]}.log").read_text()[-4000:]
        pytest.fail(f"{failed} failed:\n{tail}")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    with np.load(d / "jax_out.npz") as f:
        jax_out = {k: f[k] for k in f.files}
    return types.SimpleNamespace(ranks=ranks, jax=jax_out, dir=d)


# ---------------------------------------------------------------------------
# the single-process step
# ---------------------------------------------------------------------------

def _run():
    return RunConfig(model=reduced_config(get_config("llama3.2-1b")),
                     shape=SHAPE, parallel=PARALLEL, optimizer="adamw",
                     learning_rate=LR, warmup_steps=1)


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-process step, twice, from the same parameters and
    batch, with the clipped gradients of each step."""
    run = _run()
    cfg = run.model
    opt = make_optimizer("adamw", LR, 0.1)
    params = lm.params_from_jax(setup.jparams_np, device="cpu")
    batch = io_spec.materialize(io_spec.train_batch_spec(cfg, SHAPE), 0,
                                device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step_fn = make_train_step(run, opt)
    metrics, clipped = [], []
    for _ in range(2):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        from repro_torch.tree import tree_unflatten_like
        loss, _ = lm.loss_fn(tree_unflatten_like(state.params, leaves),
                             batch, cfg, PARALLEL)
        grads = torch.autograd.grad(loss, leaves)
        state, m = step_fn(state, batch)
        clip = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-9))
        clipped.append([g.abs() * clip for g in grads])
        metrics.append({k: float(v) for k, v in m.items()})
    return types.SimpleNamespace(state=state, metrics=metrics,
                                 clipped=clipped)


def test_sharded_step_equals_one_process(world, single):
    """Two AdamW steps of `make_train_step` on (2, 2) (fsdp, sequence
    parallel, vocab chunking 2, remat per block) equal the single-process
    step: both losses and gradient norms within 1e-5 relative, every
    parameter after step 2 to the AdamW rule (module docs); every rank
    reports the same."""
    r0 = world.ranks[0]["train"]
    for r in world.ranks[1:]:
        assert r["train"]["metrics"] == r0["metrics"]
    for got, want in zip(r0["metrics"], single.metrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=LOSS_RTOL)
        assert got["step"] == want["step"]
    ill = total = 0
    for (path, want), got, g1, g2 in zip(
            tree_flatten_with_paths(single.state.params), r0["params"],
            *single.clipped):
        d = np.abs(got - want.numpy())
        stable = ((g1 >= ADAM_G_MIN) & (g2 >= ADAM_G_MIN)).numpy()
        assert (d[stable] <= STEP_ATOL).all(), (path, d[stable].max())
        assert (d <= 2 * 2 * LR).all(), (path, d.max())
        ill += int((~stable).sum())
        total += d.size
    assert ill <= (1 - ADAM_STABLE_SHARE) * total, \
        f"{ill} of {total} parameters below a clipped |g| of 1e-7"


def test_sharded_losses_equal_jax(world):
    """The losses and gradient norms equal JAX's sharded step on its
    (2, 2) host mesh (`tests/test_distribution.py`'s step) within 1e-5
    relative."""
    m = world.ranks[0]["train"]["metrics"]
    np.testing.assert_allclose([x["loss"] for x in m], world.jax["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([x["grad_norm"] for x in m],
                               world.jax["grad_norms"], rtol=LOSS_RTOL)


def test_sharded_state_keeps_the_param_specs(world, setup):
    """Every parameter leaf after two steps is a DTensor with
    `param_specs`'s placements, the AdamW moments follow them, and the
    batch sat on `batch_specs`'s."""
    params = lm.params_from_jax(setup.jparams_np, device="cpu")
    want = [tuple(str(p) for p in s) for s in spec_leaves(
        sharding.param_specs(params, MESH22, PARALLEL))]
    bwant = [tuple(str(p) for p in s) for s in spec_leaves(
        sharding.batch_specs(io_spec.train_batch_spec(
            setup.cfg, SHAPE), MESH22, PARALLEL))]
    for r in world.ranks:
        t = r["train"]
        assert t["specs"] == want
        assert t["placements"] == want
        assert t["m_placements"] == want and t["v_placements"] == want
        assert t["batch_placements"] == bwant
    # fsdp and tensor parallel both act on the (2, 128, 128) wq stack
    assert (str(Shard(0)), str(Shard(2))) in want


def test_meshes_carry_their_device_mesh(world):
    """`make_mesh` builds a DeviceMesh of the same ranks, row-major, with
    the mesh's axis names; the production mesh refuses a world of 4; a
    DTensor outside the rules is `constrain`'s argument itself."""
    for rank, r in enumerate(world.ranks):
        m = r["mesh"]
        assert m["2x2"]["mesh"] == [[0, 1], [2, 3]]
        assert m["2x2"]["names"] == ["data", "model"]
        assert m["2x2"]["coords"] == {"data": rank // 2, "model": rank % 2}
        assert m["4x1"]["mesh"] == [[0], [1], [2], [3]]
        assert m["pipe"]["mesh"] == [0, 1, 2, 3]
        assert m["pipe"]["names"] == ["pipe"]
        assert m["2x2"]["device_type"] == "cpu"
        assert "has 256 ranks but the process group has 4" in m["production"]
        assert m["constrain_identity"]


def test_elastic_restore(world, single):
    """The step-2 parameters saved from (2, 2) (gathered, rank 0 the one
    writer) restore onto (4, 1) by its `param_specs`, and in one process
    without a mesh, to the same values."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    for r in world.ranks:
        c = r["ckpt"]
        assert c["step"] == 2 and c["equal"]
        assert c["placements"] == c["specs41"]
        assert (str(Shard(0)), str(Replicate())) in c["specs41"]
    step, tree = CheckpointManager(str(world.dir / "ckpt")).restore(
        like=single.state.params)
    assert step == 2
    for got, want in zip(tree_leaves(tree), world.ranks[0]["train"]["params"]):
        assert np.array_equal(got.numpy(), want)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_moe_constraints_equal_the_plain_call(world, setup):
    """`moe_ffn(constraints=True)` on DTensors under `activation_rules`
    (the dispatch replicated, the buckets pinned to (batch, experts)) ==
    the plain call within float32 rounding: output and load-balance
    loss."""
    want, want_lb = layers.moe_ffn(setup.moe_x, setup.moe_p, setup.moe_cfg)
    for r in world.ranks:
        m = r["moe"]
        assert _rel(m["out"], want.numpy()) <= BLOCK_RTOL
        assert float(m["lb"]) == pytest.approx(float(want_lb),
                                               rel=BLOCK_RTOL)


def test_experts_equal_the_plain_einsum_with_gradients(world, setup):
    """`layers._experts` on DTensors (the buckets over (batch, experts),
    the weights' experts over model) under `activation_rules` == the plain
    ``einsum("gecd,edf->gecf")`` within float32 rounding, and so are the
    gradients of a scalar loss for both operands (the backward pass lays
    the permuted gradient out, `contiguous_grad`)."""
    x = setup.experts_x.clone().requires_grad_(True)
    w = setup.experts_w.clone().requires_grad_(True)
    y = torch.einsum("gecd,edf->gecf", x, w)
    gx, gw = torch.autograd.grad((y ** 2).sum(), [x, w])
    for r in world.ranks:
        e = r["experts"]
        assert _rel(e["y"], y.detach().numpy()) <= BLOCK_RTOL
        assert _rel(e["gx"], gx.numpy()) <= BLOCK_RTOL
        assert _rel(e["gw"], gw.numpy()) <= BLOCK_RTOL


@pytest.fixture(scope="module")
def serve_single(setup):
    """Each serving model's prefill and decode steps in one process on
    plain tensors: the logits of every call and the last cache's leaves."""
    out = {}
    for arch, s in setup.serve.items():
        cfg = s["cfg"]
        with torch.no_grad():
            lg, cache = lm.prefill(s["params"], {"tokens": s["prompt"]}, cfg,
                                   s["max_len"], SERVE_PARALLEL)
            logits = [lg]
            for t in s["steps"]:
                lg, cache = lm.decode_step(s["params"], t, cache, cfg,
                                           SERVE_PARALLEL)
                logits.append(lg)
        out[arch] = {"logits": [x.numpy() for x in logits],
                     "cache": [x.float().numpy() for x in tree_leaves(cache)]}
    return out


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_serve_equals_one_process(world, serve_single, mesh, arch):
    """`lm.prefill` then two `lm.decode_step` calls on DTensors under
    `activation_rules`, against the same calls in one process: every
    call's logits within float32 rounding, and every leaf of the last
    cache (K/V or MLA latent written row by row into a cache whose
    positions shard over model, the prelude's, the RWKV state, the
    lengths) within one bf16 rounding of the bf16 leaves' values. After
    the prefill and after the last step every DTensor leaf of the cache is
    where `serve_cache_specs` places it (the layer axis whole, the batch
    over data; a state made anew laid out so too); on (1, 4) the 2 K/V heads are gathered before
    they are split. Placed by `cache_specs` (the layer axis over data on
    (2, 2)) the step refuses the cache by name."""
    want = serve_single[arch]
    for r in world.ranks:
        got = r["serve"][mesh][arch]
        assert len(got["logits"]) == len(want["logits"]) == 1 + SERVE_STEPS
        for g, w in zip(got["logits"], want["logits"]):
            assert _rel(g, w) <= SERVE_LOGIT_RTOL
        assert len(got["cache"]) == len(want["cache"])
        for g, w in zip(got["cache"], want["cache"]):
            g = g.astype(np.float32)
            assert g.shape == w.shape
            assert np.allclose(g, w, rtol=BF16_RTOL, atol=BF16_RTOL
                               * np.abs(w).max()), _rel(g, w)
        for placements in (got["placements"], got["decoded"]):
            placed = [(p, s) for p, s in zip(placements, got["specs"])
                      if p is not None]
            assert len(placed) >= len(got["cache"]) - 1  # all but "len"
            assert all(p == s for p, s in placed), placed
        if mesh == "2x2":
            assert "serve_cache_specs" in got["refusal"]
        else:
            assert got["refusal"] is None


def test_mamba_constraints_equal_the_plain_call(world, setup):
    """`mamba_forward(constraints=True)` on DTensors (the scan tensors
    pinned to (batch, ffn), each chunk recomputed in the backward pass) ==
    the plain call within float32 rounding: output, conv and SSM state,
    and the gradients of a scalar loss for the input and every
    parameter."""
    x = setup.mamba_x.clone().requires_grad_(True)
    leaves = [x] + [t.detach().clone().requires_grad_(True)
                    for t in tree_leaves(setup.mamba_p)]
    from repro_torch.tree import tree_unflatten_like
    out, st = mamba.mamba_forward(
        x, tree_unflatten_like(setup.mamba_p, leaves[1:]), setup.mamba_cfg)
    grads = torch.autograd.grad((out.float() ** 2).mean(), leaves)
    for r in world.ranks:
        m = r["mamba"]
        assert _rel(m["out"], out.detach().numpy()) <= BLOCK_RTOL
        assert _rel(m["conv"], st["conv"].detach().numpy()) <= BLOCK_RTOL
        assert _rel(m["ssm"], st["ssm"].detach().numpy()) <= BLOCK_RTOL
        for got, want in zip(m["grads"], grads):
            assert _rel(got, want.numpy()) <= 10 * BLOCK_RTOL


#: (block, mesh) of the head-local cases the world runs
HEAD_CASES = [(name, mesh) for name, on in HEAD_BLOCKS for mesh in on]
HEAD_EXTENTS = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(scope="module")
def heads_single(setup):
    """Each head-local block in one process on plain tensors."""
    return {name: run_head_block(name, setup.heads[name])
            for name, _ in HEAD_BLOCKS}


def _head_split(setup, name, mesh) -> tuple:
    """(data, model) extents that split a block's batch and query heads
    under `head_local`: the batch of 4 over data, the heads over model
    unless `head_branch` gathers them."""
    cfg = setup.heads[name]["cfg"]
    data, model = HEAD_EXTENTS[mesh]
    kv = cfg.n_kv_heads if name.startswith("attention") else cfg.n_heads
    branch = sharding.head_branch(cfg.n_heads, kv, model)
    return data, (1 if branch == "gathered" else model)


@pytest.mark.parametrize("name,mesh", HEAD_CASES)
def test_head_local_blocks_equal_one_process(world, heads_single, name,
                                             mesh):
    """Attention (GQA: 2 groups on (1, 4), fewer than the model ranks),
    MLA, RWKV's time mix (the chunked route with gradients, the kernel
    route from a carried state) and 6 heads that 4 ranks do not split,
    each rank on its own heads under `activation_rules` (fsdp, sequence
    parallel): outputs within float32 rounding of one process, and the
    gradients of a scalar loss for the input and every parameter within
    the Mamba block's rule."""
    want = heads_single[name]
    for r in world.ranks:
        got = r["heads"][name, mesh]
        assert len(got["outs"]) == len(want["outs"]) >= 1
        for g, w in zip(got["outs"], want["outs"]):
            assert g.shape == w.shape and _rel(g, w) <= BLOCK_RTOL
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert _rel(g, w) <= 10 * BLOCK_RTOL


@pytest.mark.parametrize("name,mesh", HEAD_CASES)
def test_head_local_score_flops_split_by_batch_and_heads(
        world, heads_single, setup, name, mesh):
    """Rank 0's counted flops of the score products (`_sdpa`) or of the
    recurrence (`wkv6`) are one process's divided by the data extent that
    splits the batch and the model extent that splits the heads, exactly;
    so is the local input's rows (batch x heads)."""
    data, model = _head_split(setup, name, mesh)
    got, want = world.ranks[0]["heads"][name, mesh], heads_single[name]
    assert want["flops"] > 0 and got["flops"] * data * model == want["flops"]
    for g, w in zip(got["shapes"], want["shapes"]):
        assert (g[0] * data, g[2] * model) == (w[0], w[2])
    assert len(got["shapes"]) == len(want["shapes"]) >= 1


def test_head_local_logs_only_the_gathered_branch(world):
    """6 query heads on 4 model ranks take `head_local`'s gathered branch,
    logged once a call with the shape; every other case logs nothing
    (`head_branch` decides from the shapes alone)."""
    assert sharding.head_branch(6, 2, 4) == "gathered"
    assert sharding.head_branch(4, 2, 4) == "grouped"
    assert sharding.head_branch(4, 2, 2) == "local"
    assert sharding.head_branch(32, 8, 16) == "grouped"
    assert sharding.head_branch(40, 8, 16) == "gathered"
    for r in world.ranks:
        for (name, mesh), got in r["heads"].items():
            if name == "attention_h6":
                assert got["head_lines"] == [
                    "sharding.head_local: 6 query heads of 2 groups (shape "
                    "(4, 16, 6, 32)) do not split over model extent 4; "
                    "gathering every head onto each model rank"]
            else:
                assert got["head_lines"] == [], (name, mesh)


def test_mamba_chunk_remat_is_bit_identical():
    """`_ssm_chunked(remat_chunks=True)` recomputes each chunk in the
    backward pass: the forward and the gradients are the plain scan's bit
    for bit (one process, plain tensors)."""
    gen = torch.Generator().manual_seed(3)
    la = -torch.rand((2, 256, 8, 4), generator=gen)
    bx = torch.randn((2, 256, 8, 4), generator=gen)
    c = torch.randn((2, 256, 4), generator=gen)
    h0 = torch.randn((2, 8, 4), generator=gen)
    outs = []
    for remat in (False, True):
        ins = [t.clone().requires_grad_(True) for t in (la, bx, c, h0)]
        y, h = mamba._ssm_chunked(*ins, 128, remat_chunks=remat)
        grads = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), ins)
        outs.append([y, h, *grads])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_compressed_psum_mean_equals_jax(world, setup):
    """Six steps of error feedback on `tests/test_distribution.py`'s
    inputs over 4 ranks: every rank's residuals equal JAX's bit for bit,
    the means are within 1e-6 of JAX's, the first step's error is under
    0.05 and the time average beats it; int8 values (and one float32
    scale a leaf) are what crossed the wire."""
    true_mean = setup.compress_g.mean(0)
    for rank, r in enumerate(world.ranks):
        c = r["compress"]
        for step in range(6):
            assert np.array_equal(c["residuals"][step],
                                  world.jax["residuals"][step][rank])
            np.testing.assert_allclose(c["means"][step],
                                       world.jax["means"][step][rank],
                                       rtol=0, atol=1e-6)
        assert c["wire"] == [("torch.int8", 64), ("torch.float32", 4)] * 6
    means = world.ranks[0]["compress"]["means"]
    first_err = float(np.abs(means[0] - true_mean).max())
    avg_err = float(np.abs(np.mean(means, axis=0) - true_mean).max())
    assert first_err < 0.05
    assert avg_err < first_err


@pytest.mark.parametrize("ring", ["p2p", "all_gather"])
def test_gpipe_equals_sequential_and_jax(world, setup, ring):
    """GPipe on ("pipe",) x 4, ``tanh(x @ w)``, 6 microbatches: every
    rank's output is bit for bit the sequential composition (computed in
    the rank's process), and within 1e-5 of JAX's `make_pipeline_fn`."""
    for r in world.ranks:
        p = r["pipe"]
        assert np.array_equal(p[ring], p["sequential"])
        np.testing.assert_allclose(p[ring], world.jax["pipe"], rtol=0,
                                   atol=1e-5)
