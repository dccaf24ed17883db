"""One rank of the port's mesh equivalence world (not collected by pytest).

    python tests/torch_mesh_worker.py SPEC RANK WORLD STORE OUT

`tests/test_torch_mesh.py` writes SPEC (``torch.save`` of a dict: the
programs as `program_from_arrays` layer dicts, the inputs, the requests
and the case list), then starts WORLD of these processes. Each joins a
gloo process group through a `FileStore` at STORE, builds every mesh the
cases name (on the CPU), runs every case through the port's mesh entry
points and writes its results to OUT/rank<RANK>.pt. Nothing here imports
JAX: the test process holds the results against the port's meshless runs
and against the JAX package.

Case kinds:

  run       ``pipeline.run_network(mesh=)``: every global result;
  megastep  a presentation driven through K-frame ``stream_megastep``
            blocks (the ragged tail masked with ``active``): each block's
            trajectories and ``frames_consumed``, and the rank's shard of
            the final state with its data coordinate;
  serve     an ``SNNServeEngine(mesh=)`` drain: every finished request,
            the aggregate report, the device ledger, and the placement of
            the pool's first page;
  op        ``ops.fused_snn_net_mesh`` on a global raster and V: the
            rasters, V and counters;
  refuse    the float backend and bitmacro on the mesh: the messages.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


def _aux(aux: dict) -> dict:
    return {k: _np(v) for k, v in aux.items()}


def run_case(case, spec, meshes, pipeline):
    from repro_torch.serve import SNNRequest, SNNServeEngine
    from repro_torch.serve.snn_engine import merge_reports
    program = spec["programs"][case["program"]]
    mesh = meshes[case["mesh"]]
    backend, kw = case["backend"], case["kw"]
    if case["kind"] == "run":
        res = pipeline.run_network(program, spec["inputs"][case["input"]],
                                   backend, mesh=mesh, **kw)
        return {"rasters": _np(res.rasters), "v_final": _np(res.v_final),
                "v_out": _np(res.v_out), "logits": _np(res.logits),
                "aux": _aux(res.aux)}
    if case["kind"] == "megastep":
        from repro_torch.dist.sharding import shard_state
        xs = spec["inputs"][case["input"]]
        k, b = case["k"], int(xs.shape[1])
        state = shard_state(pipeline.init_stream_state(program, b, backend),
                            mesh)
        blocks = []
        for lo in range(0, xs.shape[0], k):
            block = xs[lo:lo + k]
            active = None
            if block.shape[0] < k:         # ragged tail: mask it
                active = np.full(b, block.shape[0], np.int32)
                block = torch.cat([block, block.new_zeros(
                    (k - block.shape[0], *block.shape[1:]))])
            state, out = pipeline.stream_megastep(
                program, state, block, backend, active=active, mesh=mesh,
                **kw)
            blocks.append({"v_out_traj": _np(out.v_out_traj),
                           "logits_traj": _np(out.logits_traj),
                           "frames_consumed": _np(out.frames_consumed),
                           "rasters": _np(out.rasters)})
        return {"blocks": blocks, "state": _np(state.vs), "t": state.t,
                "data_coord": mesh.coord("data")}
    if case["kind"] == "serve":
        eng = SNNServeEngine(program, batch_slots=case["slots"],
                             backend=backend, step_kw=kw,
                             pages=case["pages"], megastep=case["k"],
                             device="cpu", mesh=mesh)
        for rid, frames in enumerate(spec["requests"][case["requests"]]):
            eng.submit(SNNRequest(rid=rid, frames=frames))
        eng.run_until_drained()
        done = sorted(eng.finished, key=lambda r: r.rid)
        out = {"requests": [
            {"rid": r.rid, "logits": r.logits, "v_out": r.v_out,
             "ticks": r.ticks, "finish_clock": r.finish_clock,
             "row_events": [np.asarray(x) for x in r.report.row_events],
             "events": r.report.events, "frames": r.report.frames}
            for r in done],
            "page_lanes": [int(v.shape[0]) for v in eng.states[0].vs],
            "compiled": eng._dispatch is not None}
        agg = merge_reports([r.report for r in done])
        out["aggregate"] = {"events": agg.events, "frames": agg.frames,
                            "row_events": [np.asarray(x)
                                           for x in agg.row_events]}
        if backend.endswith("events"):
            st = eng.device_event_stats()
            out["ledger"] = {"frames": st.frames,
                             "row_events": [np.asarray(x)
                                            for x in st.row_events],
                             "skipped": eng.device_skipped_row_fraction()}
        return out
    if case["kind"] == "op":
        from repro_torch.kernels.fused_snn_net.ops import fused_snn_net_mesh
        stack = program.fc_stack
        rasters, vs, skips = fused_snn_net_mesh(
            spec["inputs"][case["input"]], [s.w for s in stack],
            thresholds=[int(s.threshold) for s in stack[:-1]],
            leaks=[int(s.leak) for s in stack[:-1]], neuron=program.neuron,
            clamp_mode=program.clamp_mode, mesh=mesh,
            v_init=spec["inputs"][case["v_init"]], **kw)
        if hasattr(skips, "row_events"):           # events.EventStats
            skips = {"row_events": [np.asarray(r) for r in skips.row_events],
                     "frames": skips.frames,
                     "dense_fallbacks": list(skips.dense_fallbacks)}
        return {"rasters": _np(rasters), "v": _np(vs), "skips": _np(skips)}
    if case["kind"] == "refuse":
        msgs = []
        xs = spec["inputs"][case["input"]]
        for call in (
                lambda: pipeline.run_network(program, xs, "float", mesh=mesh),
                lambda: pipeline.run_network(program, xs, "bitmacro",
                                             mesh=mesh),
                lambda: pipeline.stream_megastep(
                    program, pipeline.init_stream_state(program, xs.shape[1],
                                                        "float"),
                    xs[:2], "float", mesh=mesh),
                lambda: SNNServeEngine(program, backend="float",
                                       device="cpu", mesh=mesh)):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        return {"messages": msgs}
    raise ValueError(f"unknown case kind {case['kind']!r}")


def main(argv) -> int:
    spec_path, rank, world, store_path, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import make_mesh
    spec = torch.load(spec_path, weights_only=False)
    spec["programs"] = {
        name: pipeline.program_from_arrays(
            p["layers"], neuron=p["neuron"], timesteps=p["timesteps"],
            clamp_mode=p["clamp_mode"], cfg=p.get("cfg"), device="cpu")
        for name, p in spec["programs"].items()}
    meshes = {shape: make_mesh(shape, device_type="cpu")
              for shape in spec["meshes"]}
    results = {}
    for case in spec["cases"]:
        results[case["id"]] = run_case(case, spec, meshes, pipeline)
    torch.save(results, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
