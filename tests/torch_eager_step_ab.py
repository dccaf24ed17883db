"""Eager train step of chip_smoke.py phase 15(a) from one source tree (not
collected by pytest; needs a CUDA card):

    python3 tests/torch_eager_step_ab.py TREE

TREE is a checkout of the repository (``.`` for this one, or a parent
commit unpacked with ``git archive``). Runs `llama3.2-1b` at full width,
bf16, B = 8, seq 256, AdamW, remat per block, 10 eager steps from seed 0
through that tree's `chip_smoke.timed_steps`, and prints one JSON line: the
median ms a step of the last half, every step's ms, the peak bytes over
the start state, the losses and a profiled step. Run trees in turns
(parent, change, change, parent) in one call to compare two commits.
"""
import json
import sys

root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

dev = torch.device("cuda", 0)
cfg = get_config(cs.SPIKING_ARCH)
run = cs.lm_run(cfg, cs.LM_TRAIN_B, cs.LM_TRAIN_SEQ, cs.LM_TRAIN_STEPS)
state, opt = init_train_state(cs.SEED, run, total_steps=cs.LM_TRAIN_STEPS,
                              device=dev)
hold = [state]        # the run takes the start state over (no other name)
del state
res = cs.timed_steps(dev, make_train_step(run, opt), hold.pop(),
                     lambda s: cs.lm_batch(cfg, cs.LM_TRAIN_B,
                                           cs.LM_TRAIN_SEQ, s, dev), 10)
print(json.dumps({"tree": root, "median_ms": res["median_ms_per_step"],
                  "ms": res["ms_per_step"], "peak_bytes": res["peak_bytes"],
                  "losses": res["losses"], "prof": res["profiled_step"]}))
