"""The port's multi-GPU dry-run (`repro_torch.launch.dryrun`) against the
JAX package's (`repro.launch.dryrun`).

Importing the JAX dry-run sets ``XLA_FLAGS`` to 512 host devices, so its
tables are read in a subprocess. The port's fake process group (256 ranks)
also lives in a subprocess (one for the decode cell, one for the score
products of a full-width prefill layer), so no pytest worker keeps a
global group. In
this process the counter runs with no mesh: fake tensors against the same
counter over the real CPU step, and the count's growth with depth. Counts
are integers held exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import (ASSIGNED_ARCHS, SHAPES,  # noqa: E402
                                      ParallelConfig, RunConfig, ShapeConfig,
                                      get_config, reduced_config)
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_ARTIFACT = ROOT / "artifacts" / "dryrun" / "single" / \
    "llama3.2-1b__decode_32k.json"
NOT_CARRIED = ("scan_layers", "unroll_time_scans")
CPU = torch.device("cpu")

JAX_TABLES = r"""
import dataclasses, json
from repro.configs.base import ASSIGNED_ARCHS, SHAPES, get_config
from repro.launch import dryrun as d
cells = d.cell_list(ASSIGNED_ARCHS, list(SHAPES))
runs = [(a, s, "") for a, s, _ in cells] + [k for k in d.HILLCLIMB]
print(json.dumps({
    "archs": list(ASSIGNED_ARCHS),
    "SHAPES": {k: dataclasses.asdict(v) for k, v in SHAPES.items()},
    "DEFAULT_TRAIN": d.DEFAULT_TRAIN, "DEFAULT_SERVE": d.DEFAULT_SERVE,
    "OVERRIDES": {"|".join(k): v for k, v in d.OVERRIDES.items()},
    "HILLCLIMB": {"|".join(k): v for k, v in d.HILLCLIMB.items()},
    "LONG_OK": sorted(d.LONG_OK),
    "cell_list": [list(c) for c in cells],
    "model_flops": {f"{a}|{s}": d.model_flops(get_config(a), SHAPES[s])
                    for a, s, _ in cells},
    "make_run": {"|".join(k): {
        "parallel": dataclasses.asdict(r.parallel),
        "optimizer": r.optimizer} for k in runs
        for r in [d.make_run(*k)]},
}))
"""

FAKE_WORLD = r"""
import json, sys
from repro_torch.launch import dryrun as d
d.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh",
        "single", "--out", sys.argv[1]])
print(json.dumps(d.check_counter(d.mesh_for("single"))))
"""

#: one layer of llama3.2-1b at full width (32 query heads, 8 groups), a
#: prefill of 32 sequences of 256 tokens: rank 0's score products on the
#: fake (16, 16) group, and the same products traced on one device
FAKE_HEADS = r"""
import dataclasses, json
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as d
from repro_torch.models import layers
run = d.make_run("llama3.2-1b", "prefill_32k")
run = dataclasses.replace(
    run, model=dataclasses.replace(run.model, n_layers=1),
    shape=ShapeConfig("heads", 256, 32, "prefill"))
calls, sdpa = [], layers._sdpa

def counted(*args, **kwargs):
    counter = d.CostCounter()
    with counter:
        out = sdpa(*args, **kwargs)
    calls.append({"flops": counter.flops, "q": list(args[0].shape),
                  "k": list(args[1].shape)})
    return out

layers._sdpa = counted
d.trace_cell(run, None)
one = calls[:]
del calls[:]
d.trace_cell(run, d.mesh_for("single"))
print(json.dumps({"one": one, "rank0": calls}))
"""


#: the repaired sites of faults 3.3 and 3.5 at full width and 64
#: tokens, on the fake (16, 16) group with ``--attribute``'s sites: the
#: llama3.2-1b train step (one layer, vocab chunking 4) on rank 0 and on
#: one device, an rwkv6-7b prefill (one layer) on rank 0, and the
#: deepseek-v2-lite-16b train step at 2 layers (the dense prelude and one
#: MoE layer) on rank 0
FAKE_SITES = r"""
import dataclasses, json
from repro_torch.launch import dryrun as d

def cut(arch, shape, n_layers=1):
    run = d.make_run(arch, shape)
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, n_layers=n_layers),
        shape=dataclasses.replace(run.shape, seq_len=64))

train, prefill = cut("llama3.2-1b", "train_4k"), cut("rwkv6-7b", "prefill_32k")
moe = cut("deepseek-v2-lite-16b", "train_4k", 2)
assert train.parallel.vocab_chunking == 4
out = {"one": d.trace_cell(train, None, attribute=True)["sites"]}
for name, run in (("rank0", train), ("rwkv", prefill), ("moe", moe)):
    kind = d.trace_device(run.shape.kind).type
    r = d.trace_cell(run, d.mesh_for("single", kind), attribute=True)
    out[name] = r.pop("sites")
    out[name + "_totals"] = r
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def jax_tables():
    pytest.importorskip("jax")
    out = subprocess.run([sys.executable, "-c", JAX_TABLES], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun_torch")
    out = subprocess.run([sys.executable, "-c", FAKE_WORLD, str(out_dir)],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    cell = json.loads((out_dir / "single" /
                       "llama3.2-1b__decode_32k.json").read_text())
    return cell, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_heads():
    out = subprocess.run([sys.executable, "-c", FAKE_HEADS], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_sites():
    out = subprocess.run([sys.executable, "-c", FAKE_SITES], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["rank0", "rwkv", "moe"])
def test_attribution_adds_up_to_the_counts(fake_sites, cell):
    """``--attribute``'s sites share out the cell's counts: their flops
    and their operand bytes of each collective kind add up to the totals
    of the same trace."""
    sites, totals = fake_sites[cell], fake_sites[cell + "_totals"]
    assert sum(row["flops"] for row in sites.values()) == totals["flops"]
    for kind, total in totals["coll"].items():
        assert sum(row["collectives"].get(kind, 0)
                   for row in sites.values()) == total, kind
    assert totals["coll"]["reduce-scatter"] > 0 or cell == "rwkv"


def test_rank0_head_backward_is_its_share(fake_sites):
    """The logits head's backward on rank 0 of the (16, 16) group is one
    device's divided by the data extent that splits the 256 sequences and
    the model extent that splits the 128,256 vocabulary columns, exactly:
    the head is gathered to (whole d, vocabulary over model) before its
    product, so no rank computes every column in partial sums. Each of
    rank 0's products spans its own rows, its own 8,016 columns and the
    whole width (the same flops over the global batch's rows by a 128-wide
    slice of d would not do)."""
    from repro_torch.models import lm
    key = f"{dryrun.line_of(lm._logits, 'x.float() @ head')} (backward)"
    one, rank0 = fake_sites["one"][key], fake_sites["rank0"][key]
    assert one["flops"] == 2 * 2 * 256 * 64 * 128_256 * 2048
    assert rank0["flops"] * 16 * 16 == one["flops"]
    rows = 16 * 64 // 4          # 16 sequences by a chunk of 16 tokens
    for product in rank0["shapes"]["flops"]:
        dims = {n for _, shape in product[1:] for n in shape}
        assert dims == {rows, 8016, 2048}, product


def test_rank0_keeps_its_batch_rows_at_the_repaired_sites(fake_sites):
    """At the logits head, the cross entropy, the FFN and attention, rank
    0 (16 of the 256 sequences) moves no activation of the global batch:
    no collective operand there has 256 rows on its leading axis, and the
    one activation reduce-scattered is attention's K and V gradient
    (grouped heads: K and V whole on each model rank, a partial gradient
    over model), of rank 0's rows alone. DTensor lays a reduce-scatter's
    operand out with its scatter axis folded onto the leading one, so that
    (16, 64, 512) gradient reads (256, 64, 32): its elements are counted.
    The faults were the chunk's float32 logits and the FFN's hidden
    gradient, each computed in partial sums over model and
    reduce-scattered."""
    import math

    from repro_torch.models import layers, lm
    sites = dryrun.sites_in(fake_sites["rank0"], (
        lm._logits, lm.loss_fn, lm._token_nll, layers.ffn, layers.attention))
    assert any("(backward)" in s for s in sites)
    kv = [dryrun.line_of(layers.attention, f'src @ p["{w}"]')
          for w in ("wk", "wv")]
    for site, row in sites.items():
        for kind, rows in row["shapes"].items():
            for operands in rows if kind != "flops" else ():
                for _, shape in operands:
                    if kind != "reduce-scatter":
                        assert shape[0] != 256, (site, kind, shape)
                    elif len(shape) > 2:             # an activation
                        assert any(k in site for k in kv), (site, shape)
                        assert math.prod(shape) == 16 * 64 * 512, shape


def test_rwkv_prefill_mixes_reduce_nothing(fake_sites):
    """An rwkv6-7b prefill (32 sequences, 2 a data rank) on rank 0: the
    token-shift mixes keep their contraction axis whole, so no product of
    `time_mix` or `channel_mix` and no input of the wkv6 recurrence
    (`head_local`) is reduce-scattered. The one reduction left is the
    channel mix's output projection, whose hidden axis is over model
    (tensor parallelism): at most one (2, 64, 4,096) bf16 tensor of rank
    0's own rows (at 64 tokens DTensor gathers the weight instead; at
    32,768 it reduce-scatters that tensor)."""
    from repro_torch.models import rwkv
    sites = dryrun.sites_in(fake_sites["rwkv"], (
        rwkv.time_mix, rwkv.channel_mix, rwkv._mix_inputs, rwkv._decay,
        rwkv._token_shift))
    assert dryrun.sites_in(sites, (rwkv.time_mix,))
    out = dryrun.line_of(rwkv.channel_mix, "h = constrain(k @")
    rs = {s: row["collectives"].get("reduce-scatter", 0)
          for s, row in sites.items()}
    assert sum(rs.pop(s) for s in list(rs) if out in s) <= 2 * 64 * 4096 * 2
    assert not any(rs.values()), rs


#: the deepseek-v2-lite-16b cut of FAKE_SITES: 256 sequences (routing
#: groups) of 64 tokens, 16 a data rank, d 2,048, 64 routed experts at
#: top-6 of d_ff 1,408, capacity 8
MOE_G, MOE_N, MOE_D, MOE_E, MOE_F, MOE_CAP = 256, 64, 2048, 64, 1408, 8


def _moe_sites(fake_sites) -> dict:
    from repro_torch.models import layers
    return dryrun.sites_in(fake_sites["moe"], (
        layers.moe_ffn, layers._route, layers._gather_combine,
        layers._combine, layers._experts))


def test_rank0_routes_only_its_own_groups(fake_sites):
    """Fault 3.5: on rank 0 of the (16, 16) group no MoE operand, forward
    or backward, holds the global batch: none has the 256 groups on its
    leading axis or the 16,384 tokens of all of them on any axis. What is
    reduce-scattered is the buckets' (d wide) or the experts' hidden
    (d_ff wide) gradient of rank 0's 16 groups alone, a tensor-parallel
    partial sum over model; DTensor folds a reduce-scatter's scatter axis
    onto the leading one, so the (16, 64, 8, 1,408) hidden gradient reads
    (256, 64, 8, 88): its elements are counted. The fault was the routing
    and combine of all 256 groups on every rank (`replicated_call`)."""
    import math

    from repro_torch.models import layers
    sites = _moe_sites(fake_sites)
    assert any("(backward)" in s for s in sites)
    assert dryrun.sites_in(sites, (layers._route,))
    own = {MOE_G // 16 * MOE_E * MOE_CAP * w for w in (MOE_D, MOE_F)}
    for site, row in sites.items():
        for kind, rows in row["shapes"].items():
            for operands in rows:
                if kind == "flops":                 # [op name, operands]
                    operands = operands[1:]
                for shape in (s for _, s in operands):
                    assert MOE_G * MOE_N not in shape, (site, kind, shape)
                    if kind == "reduce-scatter" and len(shape) > 2:
                        assert math.prod(shape) in own, (site, shape)
                    else:
                        assert shape[0] != MOE_G, (site, kind, shape)


def test_rank0_router_flops_are_its_share(fake_sites):
    """The router product on rank 0 is one device's divided by the data
    extent of 16 that splits the 256 groups, exactly: 2 · 256 · 64 · 2,048
    · 64 flops a pass on one device, counted twice forward (the block is
    recomputed in the backward pass) and twice backward (the input's and
    the router's gradients); each of rank 0's products spans its own
    1,024 tokens (16 groups of 64), the whole width and every expert."""
    from repro_torch.models import layers
    key = dryrun.line_of(layers._route, 'torch.einsum("gnd,de->gne"')
    one = 2 * MOE_G * MOE_N * MOE_D * MOE_E
    fwd, bwd = fake_sites["moe"][key], fake_sites["moe"][f"{key} (backward)"]
    assert fwd["flops"] * 16 == 2 * one
    assert bwd["flops"] * 16 == 2 * one
    for product in fwd["shapes"]["flops"] + bwd["shapes"]["flops"]:
        dims = {n for _, shape in product[1:] for n in shape}
        assert dims == {1, MOE_G // 16 * MOE_N, MOE_D, MOE_E}, product


def test_rank0_score_flops_split_by_batch_and_heads(fake_heads):
    """`layers.attention` under the dry-run's (16, 16) rules runs rank 0
    on its own heads (`head_local`'s grouped branch: 32 query heads over
    16 model ranks, each reading one of 8 groups): its score products
    count the one-device flops divided by the data extent of 16 that
    splits the 32 sequences and the model extent of 16 that splits the
    heads, exactly."""
    (one,), (rank0,) = fake_heads["one"], fake_heads["rank0"]
    assert one["q"] == [32, 256, 32, 64] and one["k"] == [32, 256, 8, 64]
    assert rank0["q"] == [2, 256, 2, 64] and rank0["k"] == [2, 256, 1, 64]
    assert one["flops"] == 2 * 2 * 32 * 32 * 256 * 256 * 64
    assert rank0["flops"] * 16 * 16 == one["flops"]


def _cells():
    return [(a, s) for a, s, _ in dryrun.cell_list(ASSIGNED_ARCHS,
                                                   list(SHAPES))]


@pytest.mark.parametrize("table", ["archs", "SHAPES", "DEFAULT_TRAIN",
                                   "DEFAULT_SERVE", "OVERRIDES", "HILLCLIMB",
                                   "LONG_OK", "cell_list"])
def test_tables_equal_jax(jax_tables, table):
    port = {
        "archs": list(ASSIGNED_ARCHS),
        "SHAPES": {k: dataclasses.asdict(v) for k, v in SHAPES.items()},
        "DEFAULT_TRAIN": dryrun.DEFAULT_TRAIN,
        "DEFAULT_SERVE": dryrun.DEFAULT_SERVE,
        "OVERRIDES": {"|".join(k): v for k, v in dryrun.OVERRIDES.items()},
        "HILLCLIMB": {"|".join(k): v for k, v in dryrun.HILLCLIMB.items()},
        "LONG_OK": sorted(dryrun.LONG_OK),
        "cell_list": [list(c) for c in dryrun.cell_list(ASSIGNED_ARCHS,
                                                        list(SHAPES))],
    }[table]
    assert json.loads(json.dumps(port)) == jax_tables[table]


def test_model_flops_equal_jax(jax_tables):
    for arch, shape in _cells():
        assert dryrun.model_flops(get_config(arch), SHAPES[shape]) == \
            jax_tables["model_flops"][f"{arch}|{shape}"], (arch, shape)


def test_make_run_equals_jax_but_the_scan_fields(jax_tables):
    keys = [(a, s, "") for a, s in _cells()] + list(dryrun.HILLCLIMB)
    assert len(jax_tables["make_run"]) == len(keys)
    for key in keys:
        run = dryrun.make_run(*key)
        want = jax_tables["make_run"]["|".join(key)]
        assert run.optimizer == want["optimizer"], key
        got = dataclasses.asdict(run.parallel)
        jax_fields = {k: v for k, v in want["parallel"].items()
                      if k not in NOT_CARRIED}
        assert {k: got[k] for k in jax_fields} == jax_fields, key


def test_decode_cell_memory_equals_the_jax_artifact(fake_world):
    cell, _ = fake_world
    want = json.loads(JAX_ARTIFACT.read_text())
    assert cell["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] == 691_351_616
    assert cell["memory"]["output_bytes"] == \
        want["memory"]["output_bytes"] == 537_127_488
    assert cell["chips"] == want["chips"] == 256
    assert cell["model_flops"] == want["model_flops"]


def test_cell_json_has_jax_keys(fake_world):
    cell, _ = fake_world
    want = set(json.loads(JAX_ARTIFACT.read_text()))
    assert set(cell) == (want - {"fits_16GiB"}) | {"fits_hbm", "hbm_bytes",
                                                   "device"}
    assert cell["device"] == "cuda"
    assert set(cell["collectives"]) == set(dryrun.COLLECTIVE_KINDS)
    assert set(cell["roofline_terms_s"]) == {"compute_s", "memory_s",
                                             "collective_s"}
    from repro_torch.launch.mesh import hbm_bytes
    assert cell["hbm_bytes"] == hbm_bytes()        # 80e9 without a card
    assert cell["fits_hbm"] == (cell["peak_bytes_per_device"]
                                <= cell["hbm_bytes"])
    mem = cell["memory"]
    assert cell["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])
    assert cell["dominant"] == max(cell["roofline_terms_s"],
                                   key=cell["roofline_terms_s"].get)


def test_one_gpu_counts_its_local_shards(fake_world):
    # 2 x 256 x 4096 x 256: the local product after W's data shards are
    # gathered, not the global 2 x 4096^3 nor DTensor's propagation
    _, mm = fake_world
    assert mm["flops"] == 2 * 256 * 4096 * 256
    assert mm["coll"]["all-gather"] == 256 * 256 * 2


def _small_run(kind: str, n_layers: int = 2) -> RunConfig:
    cfg = dataclasses.replace(reduced_config(get_config("llama3.2-1b")),
                              n_layers=n_layers)
    seq = {"train": 32, "prefill": 32, "decode": 64}[kind]
    shape = ShapeConfig(f"small_{kind}", seq, 2, kind)
    return RunConfig(model=cfg, shape=shape, parallel=_parallel_for(kind))


def _parallel_for(kind: str) -> ParallelConfig:
    base = dict(dryrun.DEFAULT_TRAIN if kind == "train"
                else dryrun.DEFAULT_SERVE)
    for name in NOT_CARRIED:
        base.pop(name, None)
    return ParallelConfig(**base)


def _real_step(run: RunConfig) -> dict:
    """`dryrun.measure` of ``run``'s step on real CPU tensors: parameters
    from `lm.init_params`, a batch from `io_spec.materialize`."""
    from repro_torch.models import io_spec, lm
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_state import TrainState, make_train_step
    cfg, par = run.model, run.parallel
    params = lm.init_params(0, cfg, device=CPU)
    if run.shape.kind == "train":
        opt = make_optimizer(run.optimizer, run.learning_rate,
                             run.weight_decay)
        batch = io_spec.materialize(io_spec.train_batch_spec(cfg, run.shape),
                                    0, device=CPU)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32))
        return dryrun.measure(make_train_step(run, opt), (state, batch),
                              lambda args, out: args[0], CPU)
    if run.shape.kind == "prefill":
        batch = io_spec.materialize(
            io_spec.prefill_batch_spec(cfg, run.shape), 0, device=CPU)
        with torch.no_grad():
            return dryrun.measure(
                lambda p, b: lm.prefill(p, b, cfg, run.shape.seq_len, par),
                (params, batch), lambda args, out: (), CPU)
    tokens, cache = io_spec.decode_spec(cfg, run.shape)
    tokens = io_spec.materialize(tokens, 0, device=CPU)
    cache = lm.init_cache(cfg, run.shape.global_batch, run.shape.seq_len,
                          device=CPU)
    with torch.no_grad():
        return dryrun.measure(
            lambda p, t, c: lm.decode_step(p, t, c, cfg, par),
            (params, tokens, cache),
            lambda args, out: [x for x in dryrun._tensors(out[1]) if any(
                x is y for y in dryrun._tensors(args[2]))], CPU)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_count_equals_the_real_cpu_step(kind):
    run = _small_run(kind)
    fake = dryrun.trace_cell(run, None, CPU)
    real = _real_step(run)
    assert fake["flops"] == real["flops"] > 0
    assert fake["bytes"] == real["bytes"] > 0
    assert fake["ops"] == real["ops"]
    assert fake["memory"] == real["memory"]
    assert fake["peak"] == real["peak"]
    assert all(v == 0 for v in fake["coll"].values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_count_is_linear_in_depth(kind):
    """Each super-block adds the same flops, bytes and operators: the
    eager step has no cost that grows faster than its depth (slicing each
    layer out of a stacked parameter once added a zero tensor of the whole
    stack to its backward pass)."""
    counts = [dryrun.trace_cell(_small_run(kind, n_layers=n), None, CPU)
              for n in (2, 3, 4)]
    for key in ("flops", "bytes", "ops"):
        a, b, c = (x[key] for x in counts)
        assert c - b == b - a > 0, (key, a, b, c)
    assert all(v == 0 for x in counts for v in x["coll"].values())


def test_wkv6_operator_fake_gives_the_kernel_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels
    from repro_torch.kernels.wkv6 import kernel
    BH, T, K, V = 6, 40, 64, 32
    dev = torch.device("cuda", 0)
    before = dict(kernels.LAUNCH_COUNTS)
    with FakeTensorMode():
        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)
        args = (f32(BH, T, K), f32(BH, T, K), f32(BH, T, V), f32(BH, T, K),
                f32(BH, K), f32(BH, K, V))
        counter = dryrun.CostCounter()
        with counter:
            y, s = kernel.wkv6_cuda(*args)
    assert (tuple(y.shape), y.dtype, y.device) == ((BH, T, V),
                                                    torch.float32, dev)
    assert (tuple(s.shape), s.dtype, s.device) == ((BH, K, V),
                                                    torch.float32, dev)
    assert kernels.LAUNCH_COUNTS == before
    flops, moved = dryrun.wkv6_cost(args[0], args[2])
    assert flops == 4 * BH * T * K * V
    assert (counter.flops, counter.bytes) == (flops, moved)


def test_counter_leaves_meta_tensors_out():
    """A ``meta`` tensor holds no memory and does no work: a sharded
    cache's layout is computed on one (`sharding.cache_zeros`), and its
    expanded copy once counted 151 GB of peak in `llama3-8b`
    `prefill_32k`. The counter counts none of it, and still counts the
    same operation on a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    meta = torch.empty((1024, 1024), device="meta")
    counter = dryrun.CostCounter()
    with counter:
        meta[None].expand(8, 1024, 1024).contiguous()
    assert (counter.ops, counter.bytes, counter.peak) == (0, 0, 0)
    with FakeTensorMode():
        fake = torch.empty((1024, 1024))
        with counter:
            fake[None].expand(8, 1024, 1024).contiguous()
    # the copy, and the fake base its view first showed the counter
    assert counter.ops == 1 and counter.peak == (8 + 1) * 1024 * 1024 * 4


def test_wkv6_operator_refuses_what_the_binding_refused():
    from repro_torch.kernels.wkv6 import kernel
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv6_cuda(x, x, x, x, x[:, 0], torch.zeros(2, 16, 16))


def test_local_shape_is_the_ceiling_shard():
    from torch.distributed.tensor import Replicate, Shard
    assert dryrun.local_shape((10, 33), (Shard(0), Shard(1)), (4, 16)) == \
        (3, 3)
    assert dryrun.local_shape((8, 512), (Replicate(), Shard(1)), (16, 16)) \
        == (8, 32)
