"""Train the paper's IMDB sentiment SNN (Fig. 9b/10) and deploy it.

GloVe-100d words -> encoder(100) -> FC128 -> FC128 -> 1 readout, RMP
neurons, 6-bit QAT weights, 11-bit V, 10 timesteps a word, membrane state
persisting across words; 29,312 trainable weights (paper: 29.3K). The data
is real IMDB + GloVe when `data.imdb.available()` (``REPRO_IMDB_DIR``,
``REPRO_GLOVE_PATH``): 2,000 training reviews, batch s drawn with numpy
seed s, the first 512 the eval set, as the JAX example does; otherwise the
structure-matched synthetic task (`data.synthetic`), batch s drawn from
seed s. Training runs through `train.make_train_step` (surrogate
gradients, AdamW without decay), compiled by `train.compile_train_step`
(one CUDA graph a step on the card), and `train.train_loop`
(``--ckpt-dir``: checkpoints every 50 steps, resumed on restart). Then the
float/QAT network and its deployed integer program on ``--backend`` are
evaluated on 512 reviews: accuracies and their agreement, the per-layer
spike sparsity (Fig. 11a), the instruction counts and macro energy per
inference, and with ``--trace`` the output V per word (Fig. 10).

    PYTHONPATH=src python -m repro_torch.launch.train_snn --device cpu --steps 25
    PYTHONPATH=src python -m repro_torch.launch.train_snn --steps 300 --backend cuda_events

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain versions
of every backend on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.impulse_snn import IMDB
from repro_torch.core import energy, snn
from repro_torch.data import imdb
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import make_sentiment_vocab, sentiment_batch
from repro_torch.optim import adamw
from repro_torch.train import (LoopConfig, TrainState, compile_train_step,
                               make_train_step, train_loop)

EVAL_BATCH, EVAL_SEED = 512, 10_001
BACKENDS = ("int_ref", "cuda", "cuda_sparse", "cuda_events")


def main(argv=None) -> tuple:
    """Parse ``argv``, train, evaluate and print; returns (float/QAT
    accuracy, deployed int accuracy)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--words", type=int, default=12)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--trace", action="store_true",
                    help="print the Fig. 10 output V trace")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="integer backend of the deployed-program eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resumes from its latest)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = IMDB

    use_real = imdb.available()
    print("data: " + ("real IMDB+GloVe" if use_real
                      else "synthetic (structure-matched)"))
    if use_real:
        xs_all, ys_all = imdb.vectorize(imdb.load_reviews("train", 2000),
                                        imdb.load_glove(), args.words)

        def batch_of(s):
            idx = np.random.default_rng(s).integers(0, len(xs_all),
                                                    args.batch)
            return xs_all[idx], ys_all[idx]
    else:
        ds = make_sentiment_vocab(args.seed)

        def batch_of(s):
            return sentiment_batch(ds, args.batch, args.words, seed=s)
    params = snn.init_fc_snn(args.seed, cfg, device=device)
    print(f"trainable params: {snn.param_count(params)} (paper: 29.3K); "
          f"LSTM baseline: 247.8K (8.5x)")
    opt = adamw(lambda s: args.lr, weight_decay=0.0)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "imdb_train", args.words * cfg.timesteps, args.batch, "train"))
    step = compile_train_step(make_train_step(
        run, opt, lambda p, b: snn.sentiment_loss(p, b["x"], b["y"], cfg,
                                                  device=device)), device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    loader = ShardedLoader(lambda s, shard, n: dict(zip(("x", "y"),
                                                        batch_of(s))))
    t0 = time.time()

    def log(m):
        print(f"step {int(m['step']):4d}  loss {m['loss']:.4f}  grad norm "
              f"{m['grad_norm']:.3f}  ({time.time() - t0:.0f}s)")

    res = train_loop(
        step, state, loader,
        LoopConfig(total_steps=args.steps, ckpt_every=50,
                   ckpt_dir=args.ckpt_dir, log_every=25),
        device_put_fn=lambda b: {k: torch.from_numpy(v).to(device)
                                 for k, v in b.items()},
        on_metrics=log)
    if res.resumed_from is not None:
        print(f"resumed from step {res.resumed_from}")
    params = res.state.params

    # ---- eval: the float/QAT network against the deployed int program ----
    xb, yb = ((xs_all[:EVAL_BATCH], ys_all[:EVAL_BATCH]) if use_real else
              sentiment_batch(ds, EVAL_BATCH, args.words, seed=EVAL_SEED))
    x = torch.from_numpy(xb).to(device)
    y = torch.from_numpy(yb).to(device)
    with torch.no_grad():
        logits, _ = snn.sentiment_apply(params, x, cfg, device=device)
    acc_f = float(torch.mean(((logits > 0) == (y > 0.5)).float()))
    logits_i, rasters, counts = snn.sentiment_apply_int(
        params, x, cfg, backend=args.backend, device=device)
    acc_i = float(torch.mean(((logits_i > 0) == (y > 0.5)).float()))
    agree = float(torch.mean(((logits_i > 0) == (logits > 0)).float()))
    print(f"\neval accuracy: float/QAT={acc_f:.4f}  "
          f"int-macro[{args.backend}]={acc_i:.4f} (agreement {agree:.3f})")
    sparsities = [1.0 - float(r.float().mean()) for r in rasters]
    print("per-layer spike sparsity (Fig.11a):",
          [f"{s:.3f}" for s in sparsities])
    e = energy.snn_energy_j(counts)
    print(f"instruction counts: {counts}")
    print(f"macro energy for {EVAL_BATCH} inferences: {e * 1e9:.2f} nJ "
          f"({e / EVAL_BATCH * 1e12:.1f} pJ/inference) at point D")

    if args.trace:
        with torch.no_grad():
            _, aux = snn.sentiment_apply(params, x[:2], cfg,
                                         return_trace=True, device=device)
        tr = aux["v_trace"].cpu().numpy()                # (T_total, 2)
        print("\nFig.10 membrane trace (output neuron V per word):")
        for b in range(2):
            lab = "positive" if float(y[b]) > 0.5 else "negative"
            line = " ".join(f"{v:+.1f}" for v in tr[::cfg.timesteps, b])
            print(f"  true={lab:8s} V/word: {line}")
    return acc_f, acc_i


if __name__ == "__main__":
    main()
