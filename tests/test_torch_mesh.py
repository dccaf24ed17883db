"""The port's SNN mesh path on `torch.distributed`: bit-identity with one
device, and with the JAX package's own mesh execution.

The port's case for case twin of `tests/test_mesh_snn.py`. Every on-macro
reduction is integer (each model rank's partial V is unclamped int32, one
integer all-reduce adds the partials, the single clamp runs after it), so
`run_network(mesh=)`, `stream_megastep(mesh=)` and `SNNServeEngine(mesh=)`
give the rasters, every V, ``v_out``, the logits, the gate and row-event
counters and the serving ledgers of the single-device run, bit for bit.

One world of 4 gloo ranks on the CPU (`tests/torch_mesh_worker.py`,
started once for the file by the module fixture, a `FileStore` under
``tmp_path``) computes every case on the meshes (4, 1), (1, 4) and (2, 2);
each parametrised test asserts its own case against

  * the port's meshless call in this process (the ``cuda*`` backends run
    their plain versions on CPU tensors), and
  * the JAX package's mesh call on conftest's 4 forced host devices, with
    its programs compiled with ``validate=False``: ``int_ref`` and
    ``ref_events`` with rasters, the Pallas backends in interpret mode
    with ``emit_rasters=False`` (this JAX cannot store rasters from a
    kernel), so there the rasters are held to the meshless run only.

The ranks import no JAX. `dist.sharding`'s `_fit`, `logical_spec` and
`snn_state_specs` are held to JAX's on dict meshes in this process.
"""
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import SpikingConfig
from repro_torch.configs.impulse_snn import SNNModelConfig
from repro_torch.core import pipeline
from repro_torch.dist import sharding
from repro_torch.dist.sharding import ShardingError
from repro_torch.serve import SNNRequest, SNNServeEngine
from repro_torch.serve.snn_engine import merge_reports

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: (n_data, n_model) meshes over 4 ranks: lanes only, row tiles only, both
MESH_SHAPES = ((4, 1), (1, 4), (2, 2))
BLOCK_B = 2                    # divides every per-rank batch of the sweep
#: (port backend, its kwargs, JAX backend, its kwargs)
BACKENDS = [
    ("int_ref", {}, "int_ref", {}),
    ("cuda", {}, "pallas", {"block_b": BLOCK_B}),
    ("cuda_sparse", {"block_b": BLOCK_B}, "pallas_sparse",
     {"block_b": BLOCK_B}),
    ("cuda_sparse", {"block_b": BLOCK_B, "gate_granularity": 4},
     "pallas_sparse", {"block_b": BLOCK_B, "gate_granularity": 4}),
    ("ref_events", {}, "ref_events", {}),
    ("cuda_events", {"block_b": BLOCK_B}, "pallas_events",
     {"block_b": BLOCK_B}),
]
_PALLAS = {"interpret": True, "emit_rasters": False}


def _case_id(backend, kw):
    return backend + (f"-g{kw['gate_granularity']}"
                      if "gate_granularity" in kw else "")


def _shape_id(shape):
    return f"d{shape[0]}m{shape[1]}"


# ---------------------------------------------------------------------------
# programs and inputs (JAX compiles, the port carries the arrays across)
# ---------------------------------------------------------------------------

def _jax_fc(layer_sizes, neuron, clamp, seed):
    import jax
    from repro.configs.base import SpikingConfig as JSpiking
    from repro.configs.impulse_snn import SNNModelConfig as JCfg
    from repro.core import pipeline as jpipe, snn as jsnn
    cfg = JCfg(arch_id="test", layer_sizes=layer_sizes,
               spiking=JSpiking(neuron=neuron, timesteps=3, threshold=1.0,
                                leak=0.0625, w_bits=6, v_bits=11),
               timesteps=3)
    return jpipe.compile_network(cfg, jsnn.init_fc_snn(
        jax.random.PRNGKey(seed), cfg), domain="int", clamp_mode=clamp,
        validate=False)


def _lenet_s(spiking_cls, cfg_cls):
    return cfg_cls(
        arch_id="lenet-s", conv_spec=((4, 3, 1), (6, 3, 2)),
        in_shape=(8, 8, 1), layer_sizes=(4 * 4 * 6, 10, 3),
        spiking=spiking_cls(neuron="rmp", timesteps=2, threshold=1.0,
                            leak=0.0625, w_bits=6, v_bits=11),
        timesteps=2, task="multiclass")


def _jax_conv(seed=0):
    import jax
    from repro.configs.base import SpikingConfig as JSpiking
    from repro.configs.impulse_snn import SNNModelConfig as JCfg
    from repro.core import pipeline as jpipe, snn as jsnn
    cfg = _lenet_s(JSpiking, JCfg)
    return jpipe.compile_network(cfg, jsnn.init_lenet_snn(
        jax.random.PRNGKey(seed), cfg), domain="int", validate=False)


def _arrays(jprog, cfg=None) -> dict:
    """A JAX program as the plain dicts `program_from_arrays` takes."""
    from test_torch_pipeline import jax_program_arrays
    return {"layers": jax_program_arrays(jprog), "neuron": jprog.neuron,
            "timesteps": jprog.timesteps, "clamp_mode": jprog.clamp_mode,
            "cfg": cfg}


def _words(batch, n_words, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n_words, d)).astype(np.float32)


SWEEP = [(n, c) for n in ("if", "lif", "rmp") for c in ("saturate", "wrap")]
MEGA_BACKENDS = [("int_ref", {}), ("cuda", {}),
                 ("cuda_events", {"block_b": BLOCK_B})]
SERVE_BACKENDS = [("int_ref", {}), ("ref_events", {}),
                  ("cuda_events", {"block_b": BLOCK_B})]
CONV_BACKENDS = [("int_ref", {}), ("cuda", {}), ("ref_events", {})]
#: `fused_snn_net_mesh`'s own modes: the plain version, and the kernel
#: wrapper dense, gated and event-list (their plain versions on the CPU)
OP_MODES = [("plain", {"use_kernel": False}), ("dense", {}),
            ("gated", {"use_sparse": True, "block_b": BLOCK_B}),
            ("events", {"use_events": True, "block_b": BLOCK_B})]


class _Setup:
    """The JAX programs, the port's copies and the inputs of every case,
    built once for the file."""

    def __init__(self):
        self.jprogs = {"fc": _jax_fc((300, 150, 20, 3), "rmp", "saturate",
                                     0),
                       "conv": _jax_conv()}
        for n, c in SWEEP:
            self.jprogs[f"sweep-{n}-{c}"] = _jax_fc((37, 51, 19, 3), n, c, 5)
        self.arrays = {k: _arrays(p, _lenet_s(SpikingConfig, SNNModelConfig)
                                  if k == "conv" else None)
                       for k, p in self.jprogs.items()}
        self.progs = {k: pipeline.program_from_arrays(
            a["layers"], neuron=a["neuron"], timesteps=a["timesteps"],
            clamp_mode=a["clamp_mode"], cfg=a["cfg"], device="cpu")
            for k, a in self.arrays.items()}
        # T = n_words x 3 frames; B = 8 (the sweep), 3 (ragged), 4 (streams)
        self.inputs = {
            "fc": pipeline.present_words(torch.from_numpy(
                _words(8, 3, 300, 7)), 3),
            "sweep": pipeline.present_words(torch.from_numpy(
                _words(3, 3, 37, 12)), 3),
            "stream": pipeline.present_words(torch.from_numpy(
                _words(4, 4, 300, 7)), 3),
            "conv": pipeline.present_static(torch.from_numpy(
                np.random.default_rng(3).standard_normal(
                    (4, 8, 8, 1)).astype(np.float32)), 2)}
        rng = np.random.default_rng(11)
        self.requests = {"fc": [rng.standard_normal((9, 300)).astype(
            np.float32) for _ in range(7)]}
        # a global raster at 20 % density and carried V for the op itself
        self.inputs["raster"] = torch.from_numpy(
            (rng.random((5, 8, 300)) < 0.2).astype(np.int8))
        self.inputs["v_init"] = [torch.from_numpy(rng.integers(
            -200, 200, (8, n)).astype(np.int32)) for n in (150, 20, 3)]
        self.cases = self._cases()

    def _cases(self) -> list:
        cases = []
        for shape in MESH_SHAPES:
            for backend, kw, _, _ in BACKENDS:
                cases.append(dict(id=f"run/{_shape_id(shape)}/"
                                  f"{_case_id(backend, kw)}", kind="run",
                                  program="fc", input="fc", mesh=shape,
                                  backend=backend, kw=kw))
        for n, c in SWEEP:
            for backend in ("int_ref", "cuda"):
                cases.append(dict(id=f"sweep/{n}-{c}/{backend}", kind="run",
                                  program=f"sweep-{n}-{c}", input="sweep",
                                  mesh=(2, 2), backend=backend, kw={}))
        for backend, kw in CONV_BACKENDS:
            cases.append(dict(id=f"conv/{backend}", kind="run",
                              program="conv", input="conv", mesh=(2, 2),
                              backend=backend, kw=kw))
        for k in (1, 8):
            for backend, kw in MEGA_BACKENDS:
                cases.append(dict(id=f"mega/{k}/{backend}", kind="megastep",
                                  program="fc", input="stream", mesh=(2, 2),
                                  backend=backend, kw=kw, k=k))
        for backend, kw in SERVE_BACKENDS:
            cases.append(dict(id=f"serve/{backend}", kind="serve",
                              program="fc", requests="fc", mesh=(2, 2),
                              backend=backend, kw=kw, slots=4, pages=2, k=4))
        # 3 lanes a page do not divide data = 2: the pool replicates
        cases.append(dict(id="serve/replicated", kind="serve", program="fc",
                          requests="fc", mesh=(2, 2), backend="cuda_events",
                          kw={"block_b": BLOCK_B}, slots=3, pages=2, k=4))
        for shape in MESH_SHAPES:
            for mode, kw in OP_MODES:
                cases.append(dict(id=f"op/{_shape_id(shape)}/{mode}",
                                  kind="op", program="fc", input="raster",
                                  v_init="v_init", mesh=shape,
                                  backend=None, kw=kw))
        cases.append(dict(id="refuse", kind="refuse", program="fc",
                          input="fc", mesh=(2, 2), backend="float", kw={}))
        return cases

    def spec(self) -> dict:
        return {"programs": self.arrays, "inputs": self.inputs,
                "requests": self.requests, "cases": self.cases,
                "meshes": sorted({c["mesh"] for c in self.cases})}


@pytest.fixture(scope="module")
def setup():
    return _Setup()


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """Every case's results on each of the 4 ranks: one gloo world for the
    file."""
    d = tmp_path_factory.mktemp("mesh_world")
    torch.save(setup.spec(), d / "spec.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for rank in range(WORLD):
        log = open(d / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
             str(d / "spec.pt"), str(rank), str(WORLD), str(d / "store"),
             str(d)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        _prefetch_jax(setup)        # the JAX oracles, while the ranks run
        for rank, (p, log) in enumerate(procs):
            if p.wait(timeout=600) != 0:
                failed.append(rank)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        tail = (d / f"rank{failed[0]}.log").read_text()[-4000:]
        pytest.fail(f"mesh ranks {failed} failed:\n{tail}")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

_JAX_CACHE: dict = {}


def _jax_run(setup, program, input_, backend, kw, shape):
    """JAX's `run_network` on its 4-device mesh of ``shape`` (None: one
    device), memoized."""
    key = (program, input_, backend, tuple(sorted(kw.items())), shape)
    if key not in _JAX_CACHE:
        import jax.numpy as jnp
        from repro.core import pipeline as jpipe
        from repro.launch.mesh import make_host_mesh
        kw = dict(kw, **_PALLAS) if backend.startswith("pallas") else kw
        mesh = None if shape is None else make_host_mesh(4, model=shape[1])
        _JAX_CACHE[key] = jpipe.run_network(
            setup.jprogs[program],
            jnp.asarray(setup.inputs[input_].numpy()), backend, mesh=mesh,
            **kw)
    return _JAX_CACHE[key]


def _prefetch_jax(setup):
    """Every JAX oracle the tests below ask for, into the memo."""
    for shape in MESH_SHAPES:
        for _, _, jbackend, jkw in BACKENDS:
            _jax_run(setup, "fc", "fc", jbackend, jkw, shape)
    for n, c in SWEEP:
        _jax_run(setup, f"sweep-{n}-{c}", "sweep", "int_ref", {}, (2, 2))
        _jax_run(setup, f"sweep-{n}-{c}", "sweep", "pallas", {"block_b": 4},
                 (2, 2))
    for jbackend in ("int_ref", "pallas", "ref_events"):
        _jax_run(setup, "conv", "conv", jbackend, {}, (2, 2))
    for k in (1, 8):
        for backend in ("int_ref", "ref_events"):
            _jax_stream(setup, backend, k)
    for backend in ("int_ref", "ref_events"):
        _jax_serve(setup, backend)


def _eq(a, b, msg):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _assert_result(got: dict, ref, tag: str, *, rasters=True):
    """A rank's global `run` result against a `NetResult` (the port's or
    JAX's): V, ``v_out``, logits and every counter, and the rasters
    unless ``rasters`` is False."""
    if rasters:
        assert len(got["rasters"]) == len(ref.rasters), tag
        for i, (a, b) in enumerate(zip(got["rasters"], ref.rasters)):
            _eq(a, b, f"{tag} raster {i}")
    for i, (a, b) in enumerate(zip(got["v_final"], ref.v_final)):
        _eq(a, b, f"{tag} V {i}")
    _eq(got["v_out"], ref.v_out, f"{tag} v_out")
    _eq(got["logits"], ref.logits, f"{tag} logits")
    aux, want = got["aux"], ref.aux
    for key in ("skip_counts", "conv_skip_counts"):
        assert (key in aux) == (key in want), f"{tag} {key}"
        if key in aux and isinstance(aux[key], list):
            for i, (a, b) in enumerate(zip(aux[key], want[key])):
                _eq(a, b, f"{tag} {key} {i}")
        elif key in aux:
            _eq(aux[key], want[key], f"{tag} {key}")
    if "row_events" in want:
        for i, (a, b) in enumerate(zip(aux["row_events"],
                                       want["row_events"])):
            _eq(a, b, f"{tag} row_events {i}")
        assert list(aux["row_event_frames"]) == \
            list(want["row_event_frames"]), tag


def _ranks_agree(world, case_id):
    """Every rank returned the same global result; rank 0's."""
    r0 = world[0][case_id]
    for rank in range(1, WORLD):
        _deep_eq(world[rank][case_id], r0, f"{case_id} rank {rank}")
    return r0


def _deep_eq(a, b, tag):
    if isinstance(a, dict):
        assert set(a) == set(b), tag
        for k in a:
            _deep_eq(a[k], b[k], f"{tag}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), tag
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_eq(x, y, f"{tag}/{i}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        _eq(a, b, tag)
    else:
        assert a == b, tag


# ---------------------------------------------------------------------------
# run_network bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,kw,jbackend,jkw", BACKENDS,
                         ids=[_case_id(b, k) for b, k, _, _ in BACKENDS])
@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[_shape_id(s) for s in MESH_SHAPES])
def test_mesh_matches_single_device(world, setup, shape, backend, kw,
                                    jbackend, jkw):
    """Every int backend on every mesh, one row-tiled program (fan-in 300
    spans three 128-row macro tiles): the global result on every rank
    equals the meshless run and JAX's mesh run bit for bit. The gate
    counters are the data ranks' tiles (``block_b`` divides every
    per-rank batch, so they equal the meshless ones) at model extent 1,
    and absent above it; the row events add over the data group."""
    case = f"run/{_shape_id(shape)}/{_case_id(backend, kw)}"
    got = _ranks_agree(world, case)
    prog, xs = setup.progs["fc"], setup.inputs["fc"]
    ref = pipeline.run_network(prog, xs, backend, **kw)
    if shape[1] > 1 and "skip_counts" in ref.aux:
        assert "skip_counts" not in got["aux"]
        ref.aux.pop("skip_counts")
        ref.aux.pop("skipped_tile_fraction", None)
        ref.aux.pop("skipped_block_fraction", None)
    _assert_result(got, ref, f"{case} vs meshless")
    if shape[1] > 1 and backend == "cuda_events":
        assert "event_dense_fallbacks" not in got["aux"]
    elif "event_dense_fallbacks" in ref.aux:
        assert got["aux"]["event_dense_fallbacks"] == \
            ref.aux["event_dense_fallbacks"]
    want = _jax_run(setup, "fc", "fc", jbackend, jkw, shape)
    _assert_result(got, want, f"{case} vs JAX mesh",
                   rasters=not jbackend.startswith("pallas"))


@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
@pytest.mark.parametrize("neuron", ["if", "lif", "rmp"])
def test_mesh_neuron_clamp_sweep(world, setup, neuron, clamp):
    """Neuron x clamp on ragged shapes (B = 3 does not divide data = 2;
    widths 37-51-19-3 are not multiples of model = 2): the batch padding
    and the post-reduction clamp stay exact in both word policies."""
    key = f"sweep-{neuron}-{clamp}"
    prog, xs = setup.progs[key], setup.inputs["sweep"]
    for backend, jbackend in (("int_ref", "int_ref"), ("cuda", "pallas")):
        case = f"sweep/{neuron}-{clamp}/{backend}"
        got = _ranks_agree(world, case)
        _assert_result(got, pipeline.run_network(prog, xs, backend), case)
        want = _jax_run(setup, key, "sweep", jbackend,
                        {"block_b": 4} if jbackend == "pallas" else {},
                        (2, 2))
        _assert_result(got, want, f"{case} vs JAX mesh",
                       rasters=jbackend == "int_ref")


@pytest.mark.parametrize("backend,kw", CONV_BACKENDS,
                         ids=[b for b, _ in CONV_BACKENDS])
def test_mesh_conv_front_end(world, setup, backend, kw):
    """A conv program on (2, 2): the im2col patch-raster calls run on the
    mesh too (each rank's examples' patch frames)."""
    case = f"conv/{backend}"
    got = _ranks_agree(world, case)
    prog, xs = setup.progs["conv"], setup.inputs["conv"]
    _assert_result(got, pipeline.run_network(prog, xs, backend, **kw), case)
    jbackend = {"cuda": "pallas"}.get(backend, backend)
    want = _jax_run(setup, "conv", "conv", jbackend, {}, (2, 2))
    _assert_result(got, want, f"{case} vs JAX mesh",
                   rasters=jbackend != "pallas")


@pytest.mark.parametrize("mode,kw", OP_MODES, ids=[m for m, _ in OP_MODES])
@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[_shape_id(s) for s in MESH_SHAPES])
def test_fused_snn_net_mesh_equals_one_device(world, setup, shape, mode, kw):
    """`ops.fused_snn_net_mesh` itself, global raster and carried V in,
    global results out on every rank: the rasters and V of
    `fused_snn_net`; the gate counters the data ranks' tiles in lane order
    at model extent 1 (None above it); the row events folded over every
    lane (no dense fallbacks above model extent 1). The plain mode equals
    JAX's `fused_snn_net_mesh(use_pallas=False)` too."""
    from repro_torch.kernels.fused_snn_net import ops
    case = f"op/{_shape_id(shape)}/{mode}"
    got = _ranks_agree(world, case)
    prog = setup.progs["fc"]
    stack = prog.fc_stack
    args = dict(thresholds=[int(s.threshold) for s in stack[:-1]],
                leaks=[int(s.leak) for s in stack[:-1]], neuron=prog.neuron,
                clamp_mode=prog.clamp_mode,
                v_init=setup.inputs["v_init"])
    spikes, ws = setup.inputs["raster"], [s.w for s in stack]
    flags = {k: v for k, v in kw.items() if k != "use_kernel"}
    if mode == "events":
        rasters, vs, st = ops.fused_snn_net_device_events(
            spikes, ws, block_b=BLOCK_B, **args)
    else:
        rasters, vs, st = ops.fused_snn_net(spikes, ws, **flags, **args)
    for i, (a, b) in enumerate(zip(got["rasters"], rasters)):
        _eq(a, b, f"{case} raster {i}")
    for i, (a, b) in enumerate(zip(got["v"], vs)):
        _eq(a, b, f"{case} V {i}")
    if mode == "gated":
        if shape[1] > 1:
            assert got["skips"] is None
        else:
            _eq(got["skips"], st, f"{case} skips")
    elif mode == "events":
        assert got["skips"]["frames"] == st.frames
        for a, b in zip(got["skips"]["row_events"], st.row_events):
            _eq(a, b, f"{case} row events")
        assert got["skips"]["dense_fallbacks"] == (
            [] if shape[1] > 1 else list(st.dense_fallbacks))
    else:
        assert got["skips"] is None
    if mode == "plain":
        import jax.numpy as jnp
        from repro.kernels.fused_snn_net import ops as jops
        from repro.launch.mesh import make_host_mesh
        jr, jv, _ = jops.fused_snn_net_mesh(
            jnp.asarray(spikes.numpy()), [jnp.asarray(w.numpy()) for w in ws],
            mesh=make_host_mesh(4, model=shape[1]), use_pallas=False,
            **{**args, "thresholds": tuple(args["thresholds"]),
               "leaks": tuple(args["leaks"]),
               "v_init": [jnp.asarray(v.numpy()) for v in args["v_init"]]})
        for a, b in zip(got["rasters"] + got["v"], list(jr) + list(jv)):
            _eq(a, b, f"{case} vs JAX")


def test_fused_snn_net_mesh_refusals(setup):
    """JAX's refusals, before any collective: gate granularity without
    gating, events with gating, events without the kernel (the host
    executor splits lanes in the pipeline)."""
    from repro_torch.kernels.fused_snn_net.ops import fused_snn_net_mesh
    stack = setup.progs["fc"].fc_stack
    args = dict(thresholds=[int(s.threshold) for s in stack[:-1]],
                leaks=[int(s.leak) for s in stack[:-1]],
                mesh={"data": 2, "model": 2})
    spikes, ws = setup.inputs["raster"], [s.w for s in stack]
    for kw, match in (({"gate_granularity": 4}, "gate_granularity"),
                      ({"use_events": True, "use_sparse": True},
                       "mutually exclusive"),
                      ({"use_events": True, "use_kernel": False},
                       "host executor")):
        with pytest.raises(ValueError, match=match):
            fused_snn_net_mesh(spikes, ws, **args, **kw)


def test_float_and_bitmacro_reject_mesh(world, setup):
    """The float backend (f32 reductions are not order-exact) and the
    bitmacro oracle (host-side state) refuse a mesh with `ValueError`
    instead of ignoring it, on the ranks and here on a dict mesh."""
    msgs = _ranks_agree(world, "refuse")["messages"]
    assert all(m is not None and "no mesh execution" in m for m in msgs)
    prog, xs = setup.progs["fc"], setup.inputs["fc"]
    mesh = {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="no mesh execution"):
        pipeline.run_network(prog, xs, "float", mesh=mesh)
    with pytest.raises(ValueError, match="no mesh execution"):
        pipeline.stream_megastep(
            prog, pipeline.init_stream_state(prog, 8, "float"), xs[:2],
            "float", mesh=mesh)
    with pytest.raises(ValueError):
        SNNServeEngine(prog, backend="float", device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# streaming megasteps on a mesh
# ---------------------------------------------------------------------------

def _gather_state(world, case):
    """The global final state from the ranks' shards (one per data
    coordinate, in order)."""
    shards = {}
    for rank in range(WORLD):
        r = world[rank][case]
        shards.setdefault(r["data_coord"], r["state"])
    return [np.concatenate([shards[d][i] for d in sorted(shards)])
            for i in range(len(shards[0]))]


def _stream_meshless(prog, xs, backend, kw, k):
    st = pipeline.init_stream_state(prog, xs.shape[1], backend)
    outs = []
    for lo in range(0, xs.shape[0], k):
        block = xs[lo:lo + k]
        active = None
        if block.shape[0] < k:
            active = np.full(xs.shape[1], block.shape[0], np.int32)
            block = torch.cat([block, block.new_zeros(
                (k - block.shape[0], *block.shape[1:]))])
        st, out = pipeline.stream_megastep(prog, st, block, backend,
                                           active=active, **kw)
        outs.append(out)
    return st, outs


def _jax_stream(setup, backend, k):
    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    from repro.launch.mesh import make_host_mesh
    key = ("stream", backend, k)
    if key not in _JAX_CACHE:
        jprog = setup.jprogs["fc"]
        xs = jnp.asarray(setup.inputs["stream"].numpy())
        mesh = make_host_mesh(4, model=2)
        st = jpipe.init_stream_state(jprog, xs.shape[1], backend)
        outs = []
        for lo in range(0, xs.shape[0], k):
            block = xs[lo:lo + k]
            active = None
            if block.shape[0] < k:
                active = np.full(xs.shape[1], block.shape[0], np.int32)
                block = jnp.concatenate([block, jnp.zeros(
                    (k - block.shape[0], *block.shape[1:]), block.dtype)])
            st, out = jpipe.stream_megastep(jprog, st, block, backend,
                                            active=active, mesh=mesh)
            outs.append(out)
        _JAX_CACHE[key] = (st, outs)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("backend,kw", MEGA_BACKENDS,
                         ids=[b for b, _ in MEGA_BACKENDS])
@pytest.mark.parametrize("k", [1, 8])
def test_mesh_megastep_stream(world, setup, k, backend, kw):
    """A presentation driven through K-frame megasteps on a (2, 2) mesh
    (T = 12: at K = 8 the second block is a masked ragged tail): each
    block's readout trajectories, ``frames_consumed`` and rasters, and the
    carried state gathered from the ranks' lane shards, equal the meshless
    drive and JAX's mesh drive (its ``int_ref``; ``ref_events`` for the
    event kernel: this JAX's Pallas megastep cannot emit the rasters its
    trajectory needs)."""
    case = f"mega/{k}/{backend}"
    r0 = world[0][case]
    for rank in range(WORLD):
        _deep_eq(world[rank][case]["blocks"], r0["blocks"],
                 f"{case} rank {rank}")
    assert all(world[r][case]["t"] == 12 + (-12) % k for r in range(WORLD))
    # each data rank holds 2 of the 4 lanes
    assert all(len(world[r][case]["state"][1]) == 2 for r in range(WORLD))
    prog, xs = setup.progs["fc"], setup.inputs["stream"]
    st, outs = _stream_meshless(prog, xs, backend, kw, k)
    jst, jouts = _jax_stream(setup, "ref_events" if backend == "cuda_events"
                             else "int_ref", k)
    assert len(r0["blocks"]) == len(outs) == len(jouts)
    for i, (got, out, jout) in enumerate(zip(r0["blocks"], outs, jouts)):
        for name in ("v_out_traj", "logits_traj", "frames_consumed"):
            _eq(got[name], getattr(out, name), f"{case} block {i} {name}")
            _eq(got[name], getattr(jout, name), f"{case} block {i} {name} "
                "vs JAX")
        for j, (a, b) in enumerate(zip(got["rasters"], out.rasters)):
            _eq(a, b, f"{case} block {i} raster {j}")
    state = _gather_state(world, case)
    for i, (a, b, c) in enumerate(zip(state, st.vs, jst.vs)):
        _eq(a, b, f"{case} carried V {i}")
        _eq(a, c, f"{case} carried V {i} vs JAX")


# ---------------------------------------------------------------------------
# serving on a partitioned pool
# ---------------------------------------------------------------------------

def _serve_meshless(setup, backend, kw, slots=4):
    eng = SNNServeEngine(setup.progs["fc"], batch_slots=slots,
                         backend=backend, step_kw=kw, pages=2, megastep=4,
                         device="cpu")
    for rid, frames in enumerate(setup.requests["fc"]):
        eng.submit(SNNRequest(rid=rid, frames=frames))
    eng.run_until_drained()
    return eng


def _jax_serve(setup, backend):
    key = ("serve", backend)
    if key not in _JAX_CACHE:
        from repro.serve import SNNRequest as JRequest
        from repro.serve import SNNServeEngine as JEngine
        eng = JEngine(setup.jprogs["fc"], batch_slots=4, backend=backend,
                      pages=2, megastep=4, validate=False)
        for rid, frames in enumerate(setup.requests["fc"]):
            eng.submit(JRequest(rid=rid, frames=frames))
        eng.run_until_drained()
        _JAX_CACHE[key] = eng
    return _JAX_CACHE[key]


def _assert_served(got: dict, eng, tag: str):
    """A rank's drain against an engine (the port's or JAX's): every
    request's logits, V, ticks, finish clock and report; the merged
    aggregate; the device ledger on the event backends."""
    done = sorted(eng.finished, key=lambda r: r.rid)
    assert [r["rid"] for r in got["requests"]] == [r.rid for r in done]
    assert len(done) == 7
    for g, w in zip(got["requests"], done):
        _eq(g["logits"], w.logits, f"{tag} rid {w.rid} logits")
        _eq(g["v_out"], w.v_out, f"{tag} rid {w.rid} v_out")
        assert (g["ticks"], g["finish_clock"]) == (w.ticks, w.finish_clock)
        assert g["events"] == w.report.events
        for i, (a, b) in enumerate(zip(g["row_events"],
                                       w.report.row_events)):
            _eq(a, b, f"{tag} rid {w.rid} row_events {i}")
    agg = merge_reports([r.report for r in done])
    assert got["aggregate"]["events"] == agg.events
    assert got["aggregate"]["frames"] == agg.frames
    for a, b in zip(got["aggregate"]["row_events"], agg.row_events):
        _eq(a, b, f"{tag} aggregate row_events")
    if "ledger" in got:
        led = eng.device_event_stats()
        assert got["ledger"]["frames"] == led.frames
        for a, b in zip(got["ledger"]["row_events"], led.row_events):
            _eq(a, b, f"{tag} ledger row_events")
        assert got["ledger"]["skipped"] == eng.device_skipped_row_fraction()


@pytest.mark.parametrize("backend,kw", SERVE_BACKENDS,
                         ids=[b for b, _ in SERVE_BACKENDS])
def test_mesh_serving_drain(world, setup, backend, kw):
    """A drain on a partitioned pool (2 pages x 4 lanes, each data rank
    holding 2 lanes of a page, rows over model = 2, K = 4) serves every
    request as the single-device engine and the JAX engine do (the JAX
    ``ref_events`` engine for the event kernel), with the same merged
    aggregate and device ledger; a gloo mesh dispatches eagerly."""
    case = f"serve/{backend}"
    got = _ranks_agree(world, case)
    assert all(n == 2 for n in got["page_lanes"])
    assert got["compiled"] is False
    _assert_served(got, _serve_meshless(setup, backend, kw), case)
    _assert_served(got, _jax_serve(setup, "int_ref" if backend == "int_ref"
                                   else "ref_events"), f"{case} vs JAX")


def test_mesh_serving_replicated_pool(world, setup):
    """3 lanes a page do not divide data = 2: `snn_state_specs` replicates
    the page (every rank holds all 3 lanes, a logged drop), and the drain
    still equals the single-device engine's."""
    got = _ranks_agree(world, "serve/replicated")
    assert all(n == 3 for n in got["page_lanes"])
    _assert_served(got, _serve_meshless(setup, "cuda_events",
                                        {"block_b": BLOCK_B}, slots=3),
                   "replicated")


# ---------------------------------------------------------------------------
# dist.sharding against JAX's
# ---------------------------------------------------------------------------

def _to_placements(spec, axes=("data", "model")) -> tuple:
    """A JAX PartitionSpec as one placement per mesh axis."""
    out = []
    for axis in axes:
        dims = [i for i, p in enumerate(spec)
                if p == axis or (isinstance(p, tuple) and axis in p)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def test_fit_divisibility_drop_warns(caplog):
    """A proposal whose dimension does not divide the extent degrades to
    replication and is logged with the axis and the extents, as JAX's."""
    from repro.dist import sharding as jsharding
    from repro.launch.mesh import make_host_mesh
    mesh = {"data": 2, "model": 2}
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.dist.sharding"):
        spec = sharding._fit(("data",), (5,), mesh)
    assert spec == (Replicate(), Replicate())
    assert spec == _to_placements(jsharding._fit(
        ("data",), (5,), make_host_mesh(4, model=2)))
    rendered = [r.getMessage() for r in caplog.records
                if r.name == "repro_torch.dist.sharding"]
    assert any("dropping axis 'data'" in m for m in rendered)
    assert any("size 5 does not divide mesh extent 2" in m
               for m in rendered)


def test_fit_required_axis_raises():
    mesh = {"data": 2, "model": 2}
    with pytest.raises(ShardingError, match="does not divide mesh extent"):
        sharding._fit(("data",), (5,), mesh, required=("data",))
    with pytest.raises(ShardingError, match="missing from mesh"):
        sharding._fit(("banks",), (4,), mesh, required=("banks",))
    assert sharding._fit(("banks",), (4,), mesh) == (Replicate(),
                                                     Replicate())


def test_fit_size_one_extent_is_honoured(caplog):
    mesh = {"data": 4, "model": 1}
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.dist.sharding"):
        spec = sharding._fit(("model",), (5,), mesh, required=("model",))
    assert spec == (Replicate(), Replicate())
    assert not [r for r in caplog.records
                if r.name == "repro_torch.dist.sharding"]


@pytest.mark.parametrize("axes,shape,required", [
    (("lane", None), (8, 16), ()),
    (("macro_row_tile", None), (6, 16), ("macro_row_tile",)),
    (("bank",), (2,), ()),
    ((("lane", "macro_row_tile"), None), (8, 3), ()),
    (("lane", "macro_row_tile"), (6, 9), ()),
])
def test_logical_spec_snn_axes(axes, shape, required):
    """The SNN logical axes resolve as JAX's do: lanes and banks to data,
    macro_row_tile to model, a tuple over both; an unknown required name
    raises."""
    from repro.dist import sharding as jsharding
    from repro.launch.mesh import make_host_mesh
    got = sharding.logical_spec({"data": 2, "model": 2}, axes, shape,
                                required=required)
    want = jsharding.logical_spec(make_host_mesh(4, model=2), axes, shape,
                                  required=required)
    assert got == _to_placements(want)
    with pytest.raises(ShardingError, match="resolves to no mesh axis"):
        sharding.logical_spec({"data": 2, "model": 2}, ("lane",), (8,),
                              required=("lanez",))


@pytest.mark.parametrize("batch", [4, 3])
def test_snn_state_specs_places_lanes(setup, batch):
    """Each V leaf's lane axis shards over data when it divides (4 lanes),
    replicates otherwise (3 lanes), and the tick counter replicates: JAX's
    `snn_state_specs`, placement for placement; `shard_state` keeps the
    rank's lanes."""
    from repro.core import pipeline as jpipe
    from repro.dist import sharding as jsharding
    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch.mesh import mesh_extents
    prog = setup.progs["fc"]
    st = pipeline.init_stream_state(prog, batch, "int_ref")
    specs = sharding.snn_state_specs(st, {"data": 2, "model": 2})
    jst = jpipe.init_stream_state(setup.jprogs["fc"], batch, "int_ref")
    jspecs = jsharding.snn_state_specs(jst, make_host_mesh(4, model=2))
    for got, want in zip(specs.vs, jspecs.vs):
        assert got == _to_placements(want.spec)
        assert got[0] == (Shard(0) if batch == 4 else Replicate())
    assert specs.t == (Replicate(), Replicate())

    class _Rank:                    # rank 3 of the (2, 2) mesh
        axis_names, shape = ("data", "model"), (2, 2)

        @staticmethod
        def coord(axis):
            return 1

    assert mesh_extents(_Rank) == {"data": 2, "model": 2}
    filled = st._replace(vs=tuple(torch.arange(v.numel()).reshape(v.shape)
                                  for v in st.vs))
    shard = sharding.shard_state(filled, _Rank)
    for v, s in zip(filled.vs, shard.vs):
        want = v[batch // 2:] if batch == 4 else v
        assert torch.equal(s, want)


def test_mesh_geometry_helpers_equal_jax():
    """`mesh_axis_extents` and `mesh_padded_widths` as JAX's."""
    from repro.kernels.fused_snn_net import ops as jops
    from repro.launch.mesh import make_host_mesh
    from repro_torch.kernels.fused_snn_net import ops
    for model in (1, 2, 4):
        assert ops.mesh_axis_extents({"data": 4 // model, "model": model}) \
            == jops.mesh_axis_extents(make_host_mesh(4, model=model))
        for widths in ((300, 150, 20, 3), (37, 51, 19, 3), (54, 10)):
            assert ops.mesh_padded_widths(widths, model) == \
                jops.mesh_padded_widths(widths, model)
