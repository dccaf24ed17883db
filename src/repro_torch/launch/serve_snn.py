"""Streaming SNN serving launcher: word streams through the V_MEM-slot
continuous-batching engine (`repro_torch.serve.SNNServeEngine`).

    PYTHONPATH=src python -m repro_torch.launch.serve_snn --requests 64 \
        --slots 32 --pages 2 --megastep 10 --backend cuda_events
    PYTHONPATH=src python -m repro_torch.launch.serve_snn --double-buffer \
        --poisson-gap 4 --stop-threshold 1.0 --megastep 10 --pages 2 \
        --slots 32 --requests 64
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.serve_snn --mesh 2,2 --device cpu --quick

``--arch`` names the network (default ``impulse-imdb``, as in the JAX
launcher); its FC stack comes from `snn.init_fc_snn`, so an arch with a
conv front end (``impulse-mnist``) is refused by `compile_network` and an
unknown name raises `KeyError`, never a quiet fallback to IMDB.
Each request is a synthetic word stream for the network: a seeded
spike raster at the offered sparsity, scaled by the encoder threshold so the
off-macro encoder reproduces it exactly (the offered sparsity is then exact,
not approximate). The network's weights are random, made from ``--seed``.
The launcher reports throughput (frames/s, words/s), the p50/p99 latency
in frame ticks (arrival to finish), the skipped-row fraction of the pooled
per-request accounting with its instruction count and measured EDP (the
macro's energy model), and on the event backends the device ledger's
skipped-row fraction. ``--backend`` is any streaming backend (``cuda``,
``cuda_sparse``, ``cuda_events``, ``int_ref``, ``ref_events``);
``--granularity`` sets ``cuda_sparse``'s gate blocks and ``--crossover``
``cuda_events``' dense fallback. ``--stop-threshold`` is the
readout-confidence early exit, ``--poisson-gap`` the mean inter-arrival
gap in frame ticks (default: every request arrives at once),
``--double-buffer`` stages the next frame block while this one computes,
and ``--quick`` serves 3 requests of 2 words on 2 slots. ``--device``
defaults to ``cuda``; ``--device cpu`` runs the plain versions on the CPU.
``--mesh DATA,MODEL`` serves on a mesh of DATA x MODEL ranks
(`launch.mesh.mesh_from_env`): under ``torchrun`` with that many
processes (NCCL on CUDA, gloo on the CPU), or alone for ``--mesh 1,1``; a
mesh of another size than the world is refused. Every rank
serves the same requests; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.impulse_snn import get_snn_config
from repro_torch.core import energy, pipeline, snn
from repro_torch.serve import SNNRequest, SNNServeEngine


def encoder_exact_frames(program, raster: np.ndarray) -> np.ndarray:
    """Input currents that make the f32 encoder emit ``raster`` exactly:
    x = threshold * raster drives V to exactly the threshold on event ticks
    (fires, resets back to rest) and leaves it unchanged on silent ones."""
    th = float(program.layers[0].threshold)
    return raster.astype(np.float32) * th


def make_requests(program, n_requests: int, n_words: int, timesteps: int,
                  sparsity: float, seed: int, stop_threshold=None,
                  poisson_gap=None) -> list:
    """Seeded synthetic word-stream requests of ``n_words * timesteps``
    frames each. ``poisson_gap`` (mean inter-arrival gap in frame ticks)
    stamps each request with a Poisson ``arrival_tick``."""
    rng = np.random.default_rng(seed)
    d = program.layers[0].n_in
    reqs = []
    arrival = 0.0
    for rid in range(n_requests):
        t_total = n_words * timesteps
        raster = (rng.random((t_total, d)) > sparsity).astype(np.int8)
        req = SNNRequest(
            rid=rid, frames=encoder_exact_frames(program, raster),
            stop_threshold=stop_threshold)
        if poisson_gap:
            arrival += rng.exponential(poisson_gap)
            req.arrival_tick = int(arrival)
        reqs.append(req)
    return reqs


def image_requests(images: np.ndarray, timesteps: int, stagger: int = 0,
                   stop_threshold=None) -> list:
    """One request per (H, W, C) image of ``images``, each the image held
    for ``timesteps`` frames (`pipeline.present_static` of one image),
    request i arriving at frame ``i * stagger`` of the engine clock."""
    return [SNNRequest(rid=i, frames=np.repeat(
                np.asarray(img, np.float32)[None], timesteps, axis=0),
                       arrival_tick=i * stagger, stop_threshold=stop_threshold)
            for i, img in enumerate(images)]


def main(argv=None) -> list:
    """Parse ``argv``, serve the requests, print the summary and return
    the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="impulse-imdb")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pages", type=int, default=1,
                    help="V-slot pool pages of --slots lanes each")
    ap.add_argument("--megastep", type=int, default=1,
                    help="frames advanced per dispatch (K)")
    ap.add_argument("--words", type=int, default=6)
    ap.add_argument("--sparsity", type=float, default=0.85)
    ap.add_argument("--backend", default="cuda",
                    choices=list(pipeline.STREAM_BACKENDS))
    ap.add_argument("--granularity", type=int, default=1,
                    help="gate blocks of 128/G fan-in rows (cuda_sparse)")
    ap.add_argument("--crossover", type=float, default=1.0,
                    help="dense-fallback occupancy (cuda_events)")
    ap.add_argument("--stop-threshold", type=float, default=None)
    ap.add_argument("--double-buffer", action="store_true",
                    help="stage the next frame block while this one computes")
    ap.add_argument("--poisson-gap", type=float, default=None,
                    help="mean inter-arrival gap in frame ticks (Poisson "
                         "admission; default: all requests arrive at once)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sizes (3 requests, 2 words, 2 slots)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh of DATA*MODEL ranks "
                         "(run under torchrun with that many processes)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import mesh_from_env
        shape = tuple(int(v) for v in args.mesh.split(","))
        if len(shape) != 2:
            raise SystemExit(f"--mesh takes DATA,MODEL, got {args.mesh!r}")
        try:
            mesh = mesh_from_env(
                shape, device_type="cpu" if args.device == "cpu" else "cuda")
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        if args.device != "cpu":
            args.device = str(mesh.device)
    if args.quick:
        args.requests, args.words, args.slots = 3, 2, 2
    step_kw = {}
    if args.backend == "cuda_sparse":
        step_kw["gate_granularity"] = args.granularity
    if args.backend == "cuda_events":
        step_kw["event_crossover"] = args.crossover

    cfg = get_snn_config(args.arch)
    program = pipeline.compile_network(cfg, snn.init_fc_snn(args.seed, cfg),
                                       domain="int", device=args.device)
    eng = SNNServeEngine(program, batch_slots=args.slots, backend=args.backend,
                         step_kw=step_kw, pages=args.pages,
                         megastep=args.megastep,
                         double_buffer=args.double_buffer, device=args.device,
                         mesh=mesh)
    for req in make_requests(program, args.requests, args.words,
                             cfg.timesteps, args.sparsity, args.seed,
                             args.stop_threshold,
                             poisson_gap=args.poisson_gap):
        eng.submit(req)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if program.device.type == "cuda":
        torch.cuda.synchronize(program.device)
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return done
    frames = sum(r.ticks for r in done)
    rep = eng.aggregate_report()
    print(f"served {len(done)} requests, {frames} frames in {dt:.3f}s "
          f"({frames / dt:.1f} frames/s, {frames / cfg.timesteps / dt:.1f} "
          f"words/s on {program.device}; backend {args.backend}, "
          f"K={args.megastep}, {args.pages} page(s) x {args.slots} lanes"
          + (f", mesh {mesh}" if mesh is not None else "") + ")")
    lats = [r.latency_ticks for r in done if r.latency_ticks is not None]
    if lats:
        print(f"latency (frame ticks, arrival->finish): "
              f"p50={np.percentile(lats, 50):.0f} "
              f"p99={np.percentile(lats, 99):.0f} "
              f"over clock {eng.clock}")
    counts = rep.instruction_counts()
    print(f"offered sparsity {args.sparsity:.2f} -> skipped-row fraction "
          f"{rep.skipped_row_fraction:.3f}, instr={counts.total}, "
          f"measured EDP {energy.measured_edp(counts):.3e} J*s")
    if args.backend.endswith("events"):
        print(f"device ledger: skipped-row fraction "
              f"{eng.device_skipped_row_fraction():.4f}, dense fallbacks "
              f"{eng.device_event_stats().dense_fallbacks}")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.ticks} ticks, logits {np.round(r.logits, 3)}")
    return done


if __name__ == "__main__":
    main()
