"""Fig. 9b at full width on the CPU: the JAX package's recipe beside the
port's, from the same initial parameters.

Both sides train the IMDB SNN (threshold init 0.5) and the LSTM baseline
with `benchmarks/fig9_accuracy.py`'s recipe: batch 128, 12 words, AdamW at
lr 5e-3 without decay or clipping, batch s drawn from seed s, and evaluate
on its 1,024-review eval batch (seed 99,991). The JAX side runs the
benchmark's jitted step; the port runs `make_train_step` and `train_loop`
on the CPU. The initial parameters are the JAX package's draws
(`PRNGKey(0)` for the SNN, `PRNGKey(1)` for the LSTM, as in the
benchmark), carried across as numpy. The port also trains the SNN from its
own numpy-seeded init (seed 0), as `chip_smoke.py` phase 12 does on the
card. Prints the loss every 50 steps and, per run, the float/QAT accuracy
(and for the port's SNN the deployed int program's on `int_ref`), then one
JSON line.

This is a measurement, not a tier-1 test (pytest does not collect it):
it takes a few minutes.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_fig9_reference.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import fig9_accuracy as fig9
from repro.core import snn as jsnn
from repro.models import lstm_baseline as jlstm
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply_updates
from repro_torch.configs.base import RunConfig
from repro_torch.configs.impulse_snn import IMDB
from repro_torch.core import pipeline, snn
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import make_sentiment_vocab, sentiment_batch
from repro_torch.models import lstm_baseline as lstm
from repro_torch.optim import adamw
from repro_torch.train import LoopConfig, TrainState, make_train_step, train_loop
from repro_torch.tree import tree_map

LR = 5e-3


def jax_train(loss_fn, params, steps):
    """`fig9_accuracy._train`'s loop, keeping the losses."""
    opt = jadamw(lambda s: LR, weight_decay=0.0)
    opt_state = opt.init(params)
    ds = make_sentiment_vocab(0)

    @jax.jit
    def step(params, opt_state, x, y):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params, x, y)
        upd, opt_state = opt.update(g, opt_state, params)
        return japply_updates(params, upd), opt_state, loss

    losses = []
    for s in range(steps):
        xb, yb = sentiment_batch(ds, fig9.BATCH, fig9.WORDS, seed=s)
        params, opt_state, loss = step(params, opt_state, jnp.asarray(xb),
                                       jnp.asarray(yb))
        losses.append(float(loss))
    return params, losses


def port_train(loss_fn, params, steps):
    opt = adamw(lambda s: LR, weight_decay=0.0)
    step = make_train_step(RunConfig(model=None, shape=None), opt,
                           lambda p, b: loss_fn(p, b["x"], b["y"]),
                           max_grad_norm=math.inf)
    ds = make_sentiment_vocab(0)
    loader = ShardedLoader(lambda s, i, n: dict(zip(
        ("x", "y"), sentiment_batch(ds, fig9.BATCH, fig9.WORDS, seed=s))))
    res = train_loop(step, TrainState(params, opt.init(params),
                                      torch.zeros((), dtype=torch.int32)),
                     loader, LoopConfig(total_steps=steps, log_every=1))
    return res.state.params, [m["loss"] for m in res.metrics_history]


def to_port(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x)),
                    jax.tree_util.tree_map(np.asarray, tree))


def accuracy(logits, y) -> float:
    return float(np.mean((np.asarray(logits) > 0) == (np.asarray(y) > 0.5)))


def every_50(losses):
    return {i + 1: round(losses[i], 4) for i in range(0, len(losses), 50)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=fig9.STEPS)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg_j = fig9.IMDB_T
    cfg = dataclasses.replace(IMDB, spiking=dataclasses.replace(
        IMDB.spiking, threshold=0.5))
    xb, yb = sentiment_batch(make_sentiment_vocab(0), 1024, fig9.WORDS,
                             seed=99_991)
    out = {"steps": args.steps}

    def report(name, losses, acc, **extra):
        row = {"acc": acc, "loss_first25": float(np.mean(losses[:25])),
               "loss_last25": float(np.mean(losses[-25:])),
               "loss_every_50": every_50(losses), **extra}
        out[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)

    p0 = jsnn.init_fc_snn(jax.random.PRNGKey(0), cfg_j)
    t0 = time.perf_counter()
    p, losses = jax_train(lambda p, x, y: jsnn.sentiment_loss(p, x, y, cfg_j),
                          p0, args.steps)
    logits, _ = jsnn.sentiment_apply(p, jnp.asarray(xb), cfg_j)
    report("jax_snn", losses, accuracy(logits, yb),
           seconds=time.perf_counter() - t0)

    def port_snn(name, params):
        t0 = time.perf_counter()
        p, losses = port_train(lambda p, x, y: snn.sentiment_loss(
            p, x, y, cfg, device="cpu"), params, args.steps)
        with torch.no_grad():
            logits, _ = snn.sentiment_apply(p, xb, cfg, device="cpu")
            prog = pipeline.compile_network(cfg, p, domain="int",
                                            device="cpu")
            res = pipeline.run_network(prog, pipeline.present_words(
                torch.from_numpy(xb), cfg.timesteps), "int_ref")
        report(name, losses, accuracy(logits, yb),
               acc_int=accuracy(res.logits[:, 0], yb),
               seconds=time.perf_counter() - t0)

    port_snn("port_snn_jax_init", to_port(p0))
    port_snn("port_snn_own_init", snn.init_fc_snn(0, cfg, device="cpu"))

    l0 = jlstm.init_lstm(jax.random.PRNGKey(1))
    lp, losses = jax_train(jlstm.lstm_loss, l0, args.steps)
    report("jax_lstm", losses,
           accuracy(jlstm.lstm_apply(lp, jnp.asarray(xb)), yb))
    lp, losses = port_train(lstm.lstm_loss, to_port(l0), args.steps)
    with torch.no_grad():
        report("port_lstm_jax_init", losses,
               accuracy(lstm.lstm_apply(lp, xb), yb))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
