"""Serving launcher: batched requests through the continuous-batching engine
(`repro_torch.serve.ServeEngine`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --max-new 12

The model is ``reduced_config`` of ``--arch`` (2 layers, d_model 128), with
random weights from ``--seed``: a dense attention config (``llama3.2-1b``
by default, ``llama3-8b``, ``phi3-medium-14b``, ``starcoder2-15b``), the
MoE super-block of ``llama4-maverick-400b-a17b`` (a dense layer and a MoE
layer of 4 experts), ``deepseek-v2-lite-16b`` (MLA, a dense prelude layer
and two MoE layers of 4 experts at top-2), the hybrid super-block of
``jamba-v0.1-52b`` (8 layers: 7 Mamba layers and one attention layer, MoE
of 4 experts at top-2 every other layer), ``rwkv6-7b``, or the text
backbone of ``llava-next-mistral-7b`` (its requests carry no patches).
``whisper-large-v3`` fails as in the JAX package: the engine's prefill
has no ``frames`` for the encoder and raises `KeyError`. Each request's
prompt is 4 to 16 random tokens. ``--device`` defaults to ``cuda``, where
prompts are prefilled through one CUDA graph per length bucket (MLA and
Mamba: eagerly at the exact length; RWKV: through the CUDA wkv6 kernel at
the exact length);
``--device cpu`` runs the same code, and the kernels' plain versions, on
the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


def make_requests(cfg, n_requests: int, max_new: int, seed: int) -> list:
    """Seeded requests with prompts of 4 to 16 tokens, drawn as the JAX
    package's launcher draws them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        plen = int(rng.integers(4, 17))
        reqs.append(Request(rid=rid,
                            prompt=rng.integers(0, cfg.vocab_size, plen),
                            max_new_tokens=max_new))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    params = lm.init_params(args.seed, cfg, device=args.device)
    engine = ServeEngine(params, cfg, batch_slots=args.slots,
                         max_len=args.max_len)
    t0 = time.perf_counter()
    for req in make_requests(cfg, args.requests, args.max_new, args.seed):
        engine.submit(req)
    done = engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s on "
          f"{engine.device})")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens -> {r.out_tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
