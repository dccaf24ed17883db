"""Training launcher for the language models (`repro.launch.train`'s
counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 --batch 8 --seq 256

It trains ``reduced_config`` of ``--arch`` (2 layers, d_model 128; for
``llama4-maverick-400b-a17b`` a dense and a MoE layer of 4 experts, for
``deepseek-v2-lite-16b`` MLA over a dense prelude layer and two MoE
layers, for ``jamba-v0.1-52b`` one hybrid super-block of 8 layers, 7 of
them Mamba): as in
the JAX launcher, ``--reduced`` is a ``store_true`` flag whose default is
already True, so no command line trains the full config (full width trains
through `chip_smoke.py`). Weights are bf16, drawn from ``--seed``; the
optimizer is ``--optimizer`` at ``--lr`` with a cosine warm-up over a tenth
of the steps; batches come from `data.lm_batch_fn`. The step is compiled
(`train.compile_train_step`: one CUDA graph of forward, backward and the
optimizer, as the JAX launcher jits it with the state donated).
``--device`` defaults to ``cuda``; ``--device cpu`` runs the same code on
the CPU (the same static-buffer plumbing, without a graph).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import (ParallelConfig, RunConfig, ShapeConfig,
                                      get_config, reduced_config)
from repro_torch.data.loader import ShardedLoader, lm_batch_fn
from repro_torch.train import (LoopConfig, compile_train_step,
                               init_train_state, make_train_step, train_loop)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    parallel = ParallelConfig(remat="block", microbatches=args.microbatches,
                              grad_compress=args.grad_compress)
    run = RunConfig(model=cfg, shape=shape, parallel=parallel,
                    optimizer=args.optimizer, learning_rate=args.lr,
                    warmup_steps=max(args.steps // 10, 1), seed=args.seed)

    state, opt = init_train_state(args.seed, run, total_steps=args.steps,
                                  device=args.device)
    device = state.step.device
    step_fn = compile_train_step(make_train_step(run, opt), device)
    batches = lm_batch_fn(cfg.vocab_size, args.batch, args.seq, args.seed)
    loader = ShardedLoader(batches, num_shards=1)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=5)
    result = train_loop(step_fn, state, loader, loop_cfg,
                        device_put_fn=lambda b: {
                            k: torch.as_tensor(v, device=device)
                            for k, v in b.items()},
                        on_metrics=lambda m: print(
                            f"step {m['step']:.0f} loss {m['loss']:.4f} "
                            f"gnorm {m['grad_norm']:.3f} "
                            f"{m['sec_per_step']:.2f}s"))
    print(f"done: {len(result.metrics_history)} logs, "
          f"resumed_from={result.resumed_from}, "
          f"stragglers={result.straggler_steps}")
    return result


if __name__ == "__main__":
    main()
