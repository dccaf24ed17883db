"""One rank of the port's LM sharding world (not collected by pytest).

    python tests/torch_lm_sharding_worker.py SPEC RANK WORLD STORE OUT

`tests/test_torch_lm_sharding.py` writes SPEC (``torch.save`` of a dict:
the reduced llama3.2-1b parameters carried across from JAX, the MoE and
Mamba blocks with their inputs, the gradient rows and the GPipe stages),
then starts WORLD of these processes. Each joins a gloo process group
through a `FileStore` at STORE, builds the meshes (2, 2), (4, 1) and
(1, 4) on ("data", "model") and (4,) on ("pipe",), all on the CPU, runs every case
through the port's entry points and writes its results to OUT/rank<RANK>.pt.
Nothing here imports JAX: the test process holds the results against the
port's single-process calls and against the JAX package.

Cases, in the order every rank runs them:

  mesh      the DeviceMesh each `make_mesh` built, `make_production_mesh`'s
            refusal, and `constrain` outside the rules on a DTensor;
  train     two steps of `make_train_step` on DTensor parameters and batch
            on (2, 2) under `activation_rules`: metrics, every parameter
            gathered, and the placements of parameters and moments;
  ckpt      the step-2 parameters saved from (2, 2) (rank 0 writes),
            restored onto (4, 1) with ``shardings=``;
  moe       `moe_ffn(constraints=True)` on DTensors on (2, 2);
  experts   `layers._experts` on DTensors on (2, 2) (experts over model)
            and the gradients of a scalar loss;
  serve     for each serving model (GQA attention, MLA with its prelude
            and MoE, RWKV), on (2, 2) and on (1, 4) (heads that 4 does not
            divide): `lm.prefill` and two `lm.decode_step` calls under
            `activation_rules`, the logits and every cache leaf gathered,
            the cache's placements, and the refusal of a cache whose
            stacked layer axis is sharded (`cache_specs`' placement);
  mamba     `mamba_forward(constraints=True)` on DTensors on (2, 2), with
            the gradient of a scalar loss;
  heads     the head-local blocks (`HEAD_BLOCKS`: attention with GQA, MLA,
            RWKV's time mix by the chunked and the kernel route, and 6
            heads that 4 ranks do not split) on (2, 2) and (1, 4), with
            gradients, the flops and shapes of their score products or
            recurrence, and the log lines of `head_local`;
  compress  six steps of `compressed_psum_mean` over the 4 ranks of (4, 1)
            on this rank's gradient row, and what crossed the wire;
  pipe      `make_pipeline_fn` on ("pipe",) x 4 with each ring, and the
            sequential composition computed here.
"""
import contextlib
import sys
import time

import torch
import torch.distributed as dist


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x


def _placements(tree):
    """Each leaf's placements as strings (None for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    return [tuple(str(p) for p in x.placements) if isinstance(x, DTensor)
            else None for x in tree_leaves(tree)]


def case_mesh(meshes):
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_production_mesh
    out = {name: {"mesh": m.device_mesh.mesh.tolist(),
                  "names": list(m.device_mesh.mesh_dim_names),
                  "device_type": m.device_mesh.device_type,
                  "coords": dict(m.coords)}
           for name, m in meshes.items()}
    try:
        make_production_mesh(device_type="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    dt = sharding.place_tree(torch.arange(8.0), meshes["2x2"],
                             sharding.logical_spec(meshes["2x2"], ("batch",),
                                                   (8,)))
    out["constrain_identity"] = sharding.constrain(dt, ("seq",)) is dt
    return out


def case_train(spec, mesh):
    from repro_torch.configs.base import RunConfig
    from repro_torch.dist import sharding
    from repro_torch.models import io_spec, lm
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_state import TrainState, make_train_step
    cfg, shape, parallel = spec["cfg"], spec["shape"], spec["parallel"]
    run = RunConfig(model=cfg, shape=shape, parallel=parallel,
                    optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
    opt = make_optimizer("adamw", 1e-3, 0.1)
    params = lm.params_from_jax(spec["params"], device="cpu")
    specs = sharding.param_specs(params, mesh, parallel)
    params = sharding.place_tree(params, mesh, specs)
    batch = io_spec.materialize(io_spec.train_batch_spec(cfg, shape), 0,
                                device="cpu")
    batch = sharding.place_tree(batch, mesh,
                                sharding.batch_specs(batch, mesh, parallel))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step_fn = make_train_step(run, opt)
    metrics, seconds = [], []
    with sharding.activation_rules(mesh, parallel):
        for _ in range(2):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, {
        "metrics": metrics, "seconds": seconds,
        "params": [_np(x) for x in
                   _leaves(sharding.gather_tree(state.params))],
        "placements": _placements(state.params),
        "specs": [tuple(str(p) for p in s) for s in _spec_leaves(specs)],
        "m_placements": _placements(state.opt_state["m"]),
        "v_placements": _placements(state.opt_state["v"]),
        "batch_placements": _placements(batch)}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _spec_leaves(specs):
    """The placement tuples of a spec tree, in leaf order (a tuple of
    placements is one leaf)."""
    from torch.distributed.tensor import Placement
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                   and not isinstance(specs[0], Placement)):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def case_ckpt(spec, state, m22, m41, ckpt_dir):
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.dist import sharding
    parallel = spec["parallel"]
    mgr = CheckpointManager(ckpt_dir, keep=1)
    mgr.save(2, state.params, blocking=True)
    dist.barrier()
    like = sharding.gather_tree(state.params)
    step, restored = mgr.restore(
        like=like, shardings=sharding.param_specs(like, m41, parallel),
        mesh=m41)
    back = sharding.gather_tree(restored)
    return {"step": step, "placements": _placements(restored),
            "specs41": [tuple(str(p) for p in s) for s in _spec_leaves(
                sharding.param_specs(like, m41, parallel))],
            "equal": all(torch.equal(a, b) for a, b in
                         zip(_leaves(back), _leaves(like)))}


def case_moe(spec, mesh):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.models import layers
    cfg, p, x = spec["moe_cfg"], spec["moe_p"], spec["moe_x"]
    parallel = spec["block_parallel"]
    dp = sharding.place_tree(p, mesh, sharding.param_specs(p, mesh,
                                                           parallel))
    dx = sharding.place_tree(x, mesh, sharding.logical_spec(
        mesh, ("batch", "seq", None), tuple(x.shape)))
    with sharding.activation_rules(mesh, parallel), implicit_replication():
        out, lb = layers.moe_ffn(dx, dp, cfg, constraints=True)
    return {"out": _np(out.full_tensor()), "placements": str(out.placements),
            "lb": _np(lb.full_tensor() if isinstance(lb, DTensor) else lb)}


def case_experts(spec, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.models import layers
    x, w = spec["experts_x"], spec["experts_w"]
    parallel = spec["block_parallel"]
    dx = sharding.place_tree(x, mesh, sharding.logical_spec(
        mesh, ("batch", "experts", None, None), tuple(x.shape)))
    dw = sharding.place_tree(w, mesh, sharding.logical_spec(
        mesh, ("experts", None, None), tuple(w.shape)))
    dx, dw = (t.detach().requires_grad_(True) for t in (dx, dw))
    with sharding.activation_rules(mesh, parallel), implicit_replication():
        y = layers._experts(dx, dw)
        gx, gw = torch.autograd.grad((y ** 2).sum(), [dx, dw])
    return {"y": _np(y.full_tensor()), "gx": _np(gx.full_tensor()),
            "gw": _np(gw.full_tensor()),
            "placements": [str(t.placements) for t in (y, gx, gw)]}


def case_serve(spec, mesh):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.models import lm
    parallel = spec["serve_parallel"]
    out = {}
    for arch, s in spec["serve"].items():
        cfg = s["cfg"]
        params = sharding.place_tree(s["params"], mesh, sharding.param_specs(
            s["params"], mesh, parallel))

        def placed(t):
            return sharding.place_tree(t, mesh, sharding.batch_specs(
                t, mesh, parallel))
        logits = []
        with torch.no_grad(), sharding.activation_rules(mesh, parallel), \
                implicit_replication():
            lg, cache = lm.prefill(params, {"tokens": placed(s["prompt"])},
                                   cfg, s["max_len"], parallel)
            logits.append(lg)
            meta = lm.init_cache(cfg, s["prompt"].shape[0], s["max_len"],
                                 device="meta")
            placements = _placements(cache)
            want = _spec_leaves(sharding.serve_cache_specs(
                meta, mesh, parallel, cfg))
            for t in s["steps"]:
                lg, cache = lm.decode_step(params, placed(t), cache, cfg,
                                           parallel)
                logits.append(lg)
            decoded = _placements(cache)
            # the same cache placed by `cache_specs`: its stacked layer
            # axis is sharded on (2, 2), and the step refuses it
            jax_placed = sharding.place_tree(
                sharding.gather_tree(cache), mesh,
                sharding.cache_specs(meta, mesh, parallel, cfg))
            try:
                lm.decode_step(params, placed(s["steps"][0]), jax_placed,
                               cfg, parallel)
                refusal = None
            except ValueError as e:
                refusal = str(e)
        out[arch] = {
            "logits": [_np(x.full_tensor() if isinstance(x, DTensor) else x)
                       for x in logits],
            "cache": [_np(x.float()) for x in
                      _leaves(sharding.gather_tree(cache))],
            "placements": placements, "decoded": decoded,
            "specs": [tuple(str(p) for p in w) for w in want],
            "refusal": refusal}
    return out


def case_mamba(spec, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.models import mamba
    cfg, p, x = spec["mamba_cfg"], spec["mamba_p"], spec["mamba_x"]
    parallel = spec["block_parallel"]
    dp = sharding.place_tree(p, mesh, sharding.param_specs(p, mesh,
                                                           parallel))
    dx = sharding.place_tree(x, mesh, sharding.logical_spec(
        mesh, ("batch", "seq", None), tuple(x.shape)))
    leaves = [dx.detach().requires_grad_(True)] + [
        t.detach().requires_grad_(True) for t in _leaves(dp)]
    from repro_torch.tree import tree_unflatten_like
    with sharding.activation_rules(mesh, parallel), implicit_replication():
        out, st = mamba.mamba_forward(
            leaves[0], tree_unflatten_like(dp, leaves[1:]), cfg,
            constraints=True)
        loss = (out.float() ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
    return {"out": _np(out.full_tensor()),
            "conv": _np(st["conv"].full_tensor()),
            "ssm": _np(st["ssm"].full_tensor()),
            "grads": [_np(g.full_tensor()) for g in grads]}


#: the head-local blocks: (block, mesh names it runs on); ``attention_h6``
#: has 6 query heads of 2 groups, which split over 2 model ranks but not 4
HEAD_BLOCKS = (("attention", ("2x2", "1x4")), ("mla", ("2x2", "1x4")),
               ("rwkv", ("2x2", "1x4")), ("rwkv_state", ("2x2", "1x4")),
               ("attention_h6", ("1x4",)))


@contextlib.contextmanager
def counted_scores():
    """Count what each call of the score products (`layers._sdpa`) and of
    the RWKV recurrence (`rwkv.wkv6`) runs, on the tensors it is given
    (a rank's local ones under `head_local`): forward flops by the
    dry-run's `CostCounter`, and the shape of the first argument."""
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.models import layers, rwkv
    rec = {"flops": 0.0, "shapes": []}

    def counting(fn):
        def counted(*args, **kwargs):
            counter = CostCounter()
            with counter:
                out = fn(*args, **kwargs)
            rec["flops"] += counter.flops
            rec["shapes"].append(tuple(args[0].shape))
            return out
        return counted
    saved = layers._sdpa, rwkv.wkv6
    layers._sdpa, rwkv.wkv6 = counting(layers._sdpa), counting(rwkv.wkv6)
    try:
        yield rec
    finally:
        layers._sdpa, rwkv.wkv6 = saved


def head_block(name, block):
    """``block``'s prefill from its inputs: the outputs (one tensor, or the
    output and the new recurrent state)."""
    from repro_torch.models import layers, rwkv
    cfg, p, x = block["cfg"], block["p"], block["x"]
    pos = torch.arange(x.shape[1])[None]
    if name.startswith("attention"):
        return layers.attention(x, p, cfg, pos)
    if name == "mla":
        return layers.mla_attention(x, p, cfg, pos)[0]
    if name == "rwkv":
        return rwkv.time_mix(x, p, cfg, use_kernel=False, chunk=16)[0]
    out, state = rwkv.time_mix(x, p, cfg, {"shift": block["shift"],
                                           "wkv": block["wkv"]})
    return out, state["wkv"]


def run_head_block(name, block, mesh=None, parallel=None) -> dict:
    """One head-local block, on one process (``mesh`` None) or on DTensors
    placed by `param_specs` and, for the input, ("batch", "seq", None)
    under `activation_rules`: the outputs, the gradients of a scalar loss
    for the input and every parameter (``rwkv_state`` takes the kernel
    route, which has none), what `counted_scores` saw, and `head_local`'s
    log lines."""
    import logging

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.tree import tree_unflatten_like
    grad = name != "rwkv_state"
    p = block["p"]
    ins = {k: block[k] for k in ("x", "shift", "wkv") if k in block}
    rules = contextlib.nullcontext()
    if mesh is not None:
        p = sharding.place_tree(p, mesh, sharding.param_specs(p, mesh,
                                                              parallel))
        ins = {k: sharding.place_tree(v, mesh, sharding.logical_spec(
            mesh, ("batch", "seq", None)[:v.dim()], tuple(v.shape)))
            for k, v in ins.items()}
        rules = sharding.activation_rules(mesh, parallel)
    leaves = [ins["x"]] + _leaves(p)
    if grad:
        leaves = [t.detach().requires_grad_(True) for t in leaves]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = logging.getLogger("repro_torch.dist.sharding")
    log.addHandler(handler)
    try:
        with rules, implicit_replication(), counted_scores() as rec, \
                torch.set_grad_enabled(grad):
            outs = head_block(name, {
                **block, **ins, "x": leaves[0],
                "p": tree_unflatten_like(p, leaves[1:])})
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = torch.autograd.grad(
                sum((o.float() ** 2).sum() for o in outs), leaves) \
                if grad else []
    finally:
        log.removeHandler(handler)
    return {"outs": [_np(sharding.gather_tree(o)) for o in outs],
            "grads": [_np(sharding.gather_tree(g)) for g in grads],
            "flops": rec["flops"], "shapes": rec["shapes"],
            "head_lines": [m for m in lines if "head_local" in m]}


def case_heads(spec, meshes):
    out = {}
    for name, on in HEAD_BLOCKS:
        for mesh_name in on:
            t0 = time.perf_counter()
            out[name, mesh_name] = run_head_block(
                name, spec["heads"][name], meshes[mesh_name],
                spec["parallel"])
            out[name, mesh_name]["s"] = time.perf_counter() - t0
    return out


def case_compress(spec, mesh, rank):
    from repro_torch.dist.compress import compressed_psum_mean
    g = {"w": spec["compress_g"][rank].clone()}
    r = {"w": torch.zeros_like(g["w"])}
    wire = []
    all_gather = dist.all_gather

    def recording(tensor_list, tensor, group=None, async_op=False):
        wire.append((str(tensor.dtype), tensor.numel()
                     * tensor.element_size()))
        return all_gather(tensor_list, tensor, group=group,
                          async_op=async_op)
    means, residuals = [], []
    dist.all_gather = recording
    try:
        for _ in range(6):
            out, r = compressed_psum_mean(g, r, "data", mesh)
            means.append(_np(out["w"]))
            residuals.append(_np(r["w"]))
    finally:
        dist.all_gather = all_gather
    return {"means": means, "residuals": residuals, "wire": wire}


def case_pipe(spec, mesh):
    from repro_torch.dist import pipeline
    Ws, xs = spec["pipe_ws"], spec["pipe_xs"]

    def stage(w, x):
        return torch.tanh(x @ w)
    out = {}
    ring_of = pipeline.ring_of
    for ring in ("p2p", "all_gather"):
        # the CPU takes point to point; the all-gather ring is what a gloo
        # mesh on CUDA takes, run here by selecting it
        pipeline.ring_of = lambda m, ring=ring: ring
        try:
            out[ring] = _np(pipeline.make_pipeline_fn(
                stage, mesh, "pipe", xs.shape[0])(Ws, xs))
        finally:
            pipeline.ring_of = ring_of
    seq = []
    for m in range(xs.shape[0]):
        x = xs[m]
        for s in range(Ws.shape[0]):
            x = stage(Ws[s], x)
        seq.append(x)
    out["sequential"] = _np(torch.stack(seq))
    return out


def main(argv) -> int:
    spec_path, rank, world, store_path, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_mesh
    spec = torch.load(spec_path, weights_only=False)
    meshes = {"2x2": make_mesh((2, 2), device_type="cpu"),
              "4x1": make_mesh((4, 1), device_type="cpu"),
              "1x4": make_mesh((1, 4), device_type="cpu"),
              "pipe": make_mesh((4,), ("pipe",), device_type="cpu")}
    t0 = time.perf_counter()
    results = {"mesh": case_mesh(meshes)}
    state, results["train"] = case_train(spec, meshes["2x2"])
    results["ckpt"] = case_ckpt(spec, state, meshes["2x2"], meshes["4x1"],
                                f"{out_dir}/ckpt")
    results["moe"] = case_moe(spec, meshes["2x2"])
    results["experts"] = case_experts(spec, meshes["2x2"])
    results["serve"] = {name: case_serve(spec, meshes[name])
                        for name in ("2x2", "1x4")}
    results["mamba"] = case_mamba(spec, meshes["2x2"])
    results["heads"] = case_heads(spec, meshes)
    results["compress"] = case_compress(spec, meshes["4x1"], rank)
    results["pipe"] = case_pipe(spec, meshes["pipe"])
    results["seconds"] = time.perf_counter() - t0
    torch.save(results, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
