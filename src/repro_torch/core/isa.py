"""Word-level integer semantics of the macro: the four instructions on one
macro's state (`MacroState`, `acc_w2v`, `acc_v2v`, `spike_check`,
`reset_v`, the neuron-update sequence and `timestep`), the timestep
vectorized over a layer tile (the plain PyTorch contract the CUDA kernels
are held against), and the instruction accounting of the energy model.
The bit-level `macro.BitMacro` is held against the single-macro ops.

The macro's instruction sequence per timestep is AccW2V (accumulate the
weight rows of firing inputs into V), then the neuron update: the LIF leak
(AccV2V with the negative leak row), SpikeCheck, and the reset (RMP
subtracts the threshold, IF/LIF reset V to ``reset``).

Macro geometry (the fabricated 65nm instance):
  W_MEM: 128 rows x 12 six-bit signed weights (one row per input neuron)
  V_MEM: 32 rows x 6 twelve-bit slots; a neuron set (12 neurons) spans 2
         staggered rows (odd-parity slots + even-parity slots). 6 constant
         rows (threshold/reset/leak, odd+even each) leave 13 neuron sets.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.quant import clamp_v, spike_compare

MACRO_IN = 128          # input rows
MACRO_OUT = 12          # weights (output neurons) per row
V_ROWS = 32
V_SLOTS_PER_ROW = 6
N_CONST_ROWS = 6        # threshold_o/e, reset_o/e, leak_o/e
N_NEURON_SETS = (V_ROWS - N_CONST_ROWS) // 2    # 13


class InstrCount(NamedTuple):
    """Executed-cycle counts per instruction type (energy model input)."""
    acc_w2v: int = 0
    acc_v2v: int = 0
    spike_check: int = 0
    reset_v: int = 0

    def __add__(self, o: "InstrCount") -> "InstrCount":
        return InstrCount(*(a + b for a, b in zip(self, o)))

    @property
    def total(self) -> int:
        return sum(self)


@dataclass
class MacroState:
    """Logical state of one macro (word level), as tensors."""
    wmem: torch.Tensor                    # (128, 12) int8 in [-31, 31]
    vmem: torch.Tensor                    # (N_SETS, 12) int32, 11-bit clamped
    threshold: torch.Tensor               # (12,) int32 (stored negated on-chip)
    reset: torch.Tensor                   # (12,) int32
    leak: torch.Tensor                    # (12,) int32 (stored negated on-chip)
    spike_buf: torch.Tensor               # (N_SETS, 12) bool
    clamp_mode: str = "saturate"


def make_state(wq, threshold: int, reset: int = 0, leak: int = 0,
               clamp_mode: str = "saturate") -> MacroState:
    """A macro holding the (128, 12) weight tile ``wq`` (an array or a
    tensor), V at 0 and the given constants."""
    wq = torch.as_tensor(np.asarray(wq.cpu() if torch.is_tensor(wq) else wq))
    if tuple(wq.shape) != (MACRO_IN, MACRO_OUT):
        raise ValueError(f"macro weight tile must be "
                         f"{(MACRO_IN, MACRO_OUT)}, got {tuple(wq.shape)}")
    return MacroState(
        wmem=wq.to(torch.int8),
        vmem=torch.zeros((N_NEURON_SETS, MACRO_OUT), dtype=torch.int32),
        threshold=torch.full((MACRO_OUT,), threshold, dtype=torch.int32),
        reset=torch.full((MACRO_OUT,), reset, dtype=torch.int32),
        leak=torch.full((MACRO_OUT,), leak, dtype=torch.int32),
        spike_buf=torch.zeros((N_NEURON_SETS, MACRO_OUT), dtype=torch.bool),
        clamp_mode=clamp_mode)


# Instructions. ``cycle``: 0 = odd (even-indexed weight groups), 1 = even.
# Each call models one executed macro cycle and returns a new state.

def _parity_mask(cycle: int) -> torch.Tensor:
    m = torch.zeros(MACRO_OUT, dtype=torch.bool)
    m[cycle::2] = True
    return m


def _set_row(x: torch.Tensor, i: int, row: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[i] = row
    return out


def acc_w2v(st: MacroState, set_idx: int, in_row, cycle: int) -> MacroState:
    """V[set, parity] += W[in_row, parity] (triple-row decode: RWLo/e + V
    RWL + WWL)."""
    w = st.wmem[int(in_row)].to(torch.int32)
    v = st.vmem[set_idx]
    v = torch.where(_parity_mask(cycle), clamp_v(v + w, st.clamp_mode), v)
    return replace(st, vmem=_set_row(st.vmem, set_idx, v))


def acc_v2v(st: MacroState, set_idx: int, add: torch.Tensor, cycle: int,
            conditional: bool = False) -> MacroState:
    """V[set, parity] += add[parity]; with ``conditional`` only where the
    spike buffer is set (the conditional write drivers: RMP soft reset)."""
    mask = _parity_mask(cycle)
    if conditional:
        mask = mask & st.spike_buf[set_idx]
    v = st.vmem[set_idx]
    v = torch.where(mask, clamp_v(v + add.to(torch.int32), st.clamp_mode), v)
    return replace(st, vmem=_set_row(st.vmem, set_idx, v))


def spike_check(st: MacroState, set_idx: int, cycle: int) -> MacroState:
    """Compare V against the threshold (adder as comparator) and latch the
    parity's spike buffers; V is not written. In ``wrap`` mode the
    comparison wraps (`quant.spike_compare`)."""
    fired = spike_compare(st.vmem[set_idx], st.threshold, st.clamp_mode)
    buf = torch.where(_parity_mask(cycle), fired, st.spike_buf[set_idx])
    return replace(st, spike_buf=_set_row(st.spike_buf, set_idx, buf))


def reset_v(st: MacroState, set_idx: int, cycle: int) -> MacroState:
    """Rewrite V from the reset row where the spike buffer is set (BLFA
    bypassed: SINV -> CWD direct)."""
    mask = _parity_mask(cycle) & st.spike_buf[set_idx]
    v = torch.where(mask, st.reset, st.vmem[set_idx])
    return replace(st, vmem=_set_row(st.vmem, set_idx, v))


def neuron_update(st: MacroState, set_idx: int, neuron: str
                  ) -> tuple[MacroState, torch.Tensor, InstrCount]:
    """End-of-timestep neuron update for both parities (Fig. 6). Returns
    (state, (12,) spikes, cycles)."""
    cnt = InstrCount()
    if neuron == "lif":
        for c in (0, 1):
            st = acc_v2v(st, set_idx, -st.leak, c)
        cnt += InstrCount(acc_v2v=2)
    for c in (0, 1):
        st = spike_check(st, set_idx, c)
    cnt += InstrCount(spike_check=2)
    if neuron == "rmp":                      # soft reset: AccV2V(-th), gated
        for c in (0, 1):
            st = acc_v2v(st, set_idx, -st.threshold, c, conditional=True)
        cnt += InstrCount(acc_v2v=2)
    elif neuron in ("if", "lif"):
        for c in (0, 1):
            st = reset_v(st, set_idx, c)
        cnt += InstrCount(reset_v=2)
    else:
        raise ValueError(neuron)
    return st, st.spike_buf[set_idx], cnt


def timestep(st: MacroState, set_idx: int, in_spikes, neuron: str
             ) -> tuple[MacroState, torch.Tensor, InstrCount]:
    """One SNN timestep on one macro: AccW2V (odd and even cycle) per
    spiking input row of the (128,) event list ``in_spikes``, then the
    neuron update. Only spiking rows issue instructions."""
    in_spikes = torch.as_tensor(np.asarray(
        in_spikes.cpu() if torch.is_tensor(in_spikes) else in_spikes))
    rows = torch.nonzero(in_spikes.to(torch.bool)).flatten().tolist()
    for r in rows:
        st = acc_w2v(st, set_idx, r, cycle=0)
        st = acc_w2v(st, set_idx, r, cycle=1)
    st, spikes, c2 = neuron_update(st, set_idx, neuron)
    return st, spikes, InstrCount(acc_w2v=2 * len(rows)) + c2


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product ``a @ b`` of two integer tensors, narrowed to
    int32 with two's-complement wraparound (the result an int32 matmul that
    wraps would give).

    On the CPU the product runs in int64. CUDA has no integer matmul, so
    there it runs in float64, which is exact while every partial sum stays
    below 2**53 in magnitude: spikes are {0, 1} and weights 6-bit, so that
    holds for any fan-in below 2**47."""
    if a.device.type == "cpu":
        acc = torch.matmul(a.to(torch.int64), b.to(torch.int64))
    else:
        # exact below 2**53 (the trace pass proves the bound per product)
        acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))  # noqa: ANA005
        acc = acc.to(torch.int64)
    return acc.to(torch.int32)


def neuron_dynamics_int(v: torch.Tensor, *, neuron: str, threshold, leak,
                        reset=0, clamp_mode: str = "saturate"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The post-accumulation half of a timestep: leak / SpikeCheck / reset
    on an already-accumulated and clamped int32 V. Returns (v', spikes) with
    int32 {0, 1} spikes."""
    if neuron == "lif":
        v = clamp_v(v - leak, clamp_mode)
    s = spike_compare(v, threshold, clamp_mode)
    if neuron == "rmp":
        v = clamp_v(torch.where(s, v - threshold, v), clamp_mode)
    else:
        v = torch.where(s, torch.full_like(v, reset), v)
    return v, s.to(torch.int32)


def layer_timestep_int(v: torch.Tensor, wq: torch.Tensor,
                       in_spikes: torch.Tensor, *, neuron: str, threshold,
                       leak, reset=0, clamp_mode: str = "saturate"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched integer timestep: v (..., n_out) int32, wq (n_in, n_out) int8,
    in_spikes (..., n_in) {0, 1}. The AccW2V product is exact (see
    `int_matmul`); V then clamps to the 11-bit word before the neuron
    update. Returns (v', out_spikes)."""
    v = clamp_v(v + int_matmul(in_spikes, wq), clamp_mode)
    return neuron_dynamics_int(v, neuron=neuron, threshold=threshold,
                               leak=leak, reset=reset, clamp_mode=clamp_mode)


def conv_layer_timestep_int(v: torch.Tensor, wq: torch.Tensor,
                            in_spikes: torch.Tensor, *, stride: int,
                            neuron: str, threshold, leak, reset=0,
                            clamp_mode: str = "saturate"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched integer conv timestep: v (B, H_out, W_out, c_out) int32, wq
    the HWIO int8 kernel (k, k, c_in, c_out), in_spikes (B, H, W, c_in)
    {0, 1}. Lowered through im2col (`mapping.im2col`): every output
    position is a frame whose k*k*c_in patch vector drives
    `layer_timestep_int` on the packed (k*k*c_in, c_out) weights. Returns
    (v', out_spikes), both (B, H_out, W_out, c_out)."""
    from repro_torch.core import mapping
    patches = mapping.im2col(in_spikes, wq.shape[0], stride)
    return layer_timestep_int(v, mapping.pack_conv_weights(wq), patches,
                              neuron=neuron, threshold=threshold, leak=leak,
                              reset=reset, clamp_mode=clamp_mode)


def count_layer_instructions_from_events(total_events: int, batch_t: int,
                                         n_in: int, n_out: int, neuron: str
                                         ) -> InstrCount:
    """Instruction cycles of a (n_in -> n_out) layer from its aggregate
    event statistics: ``total_events`` input spikes over ``batch_t``
    (timestep, example) frames, on the multi-macro tiling of
    `mapping.fc_tiling`. Every event costs 2 AccW2V cycles (odd and even
    parity) per column tile; each row tile beyond the first adds 2 AccV2V
    partial-sum reductions per column tile and frame; the neuron update
    ("none" for the accumulate-only readout) runs per column tile and
    frame."""
    from repro_torch.core import mapping
    tiles = mapping.fc_tiling(n_in, n_out)
    n_acc_w = 2 * int(total_events) * tiles.col_tiles
    n_red = 2 * (tiles.row_tiles - 1) * tiles.col_tiles * batch_t
    cnt = InstrCount(acc_w2v=n_acc_w, acc_v2v=n_red)
    per_update = {"if": InstrCount(spike_check=2, reset_v=2),
                  "lif": InstrCount(acc_v2v=2, spike_check=2, reset_v=2),
                  "rmp": InstrCount(spike_check=2, acc_v2v=2),
                  "none": InstrCount()}[neuron]
    upd = InstrCount(*(x * tiles.col_tiles * batch_t for x in per_update))
    return cnt + upd


def count_skipped_instructions_from_events(total_events: int, batch_t: int,
                                           n_in: int, n_out: int
                                           ) -> InstrCount:
    """AccW2V cycles event-driven execution never issues for a
    (n_in -> n_out) layer: 2 per column tile for every silent (frame,
    input-row) pair, so executed + skipped is the dense tally at sparsity
    0. Raises `ValueError` when ``total_events`` exceeds the sites."""
    from repro_torch.core import mapping
    silent = batch_t * n_in - int(total_events)
    if silent < 0:
        raise ValueError(f"event count {total_events} exceeds the "
                         f"{batch_t * n_in} (frame, row) sites of a "
                         f"{n_in}->{n_out} layer over {batch_t} frames")
    tiles = mapping.fc_tiling(n_in, n_out)
    return InstrCount(acc_w2v=2 * silent * tiles.col_tiles)


def count_layer_instructions(spike_raster, n_in: int, n_out: int,
                             neuron: str) -> InstrCount:
    """Instruction cycles of a (n_in -> n_out) layer on a (T, ..., n_in)
    spike raster (an array or a tensor); see
    `count_layer_instructions_from_events`."""
    r = np.asarray(spike_raster.cpu() if torch.is_tensor(spike_raster)
                   else spike_raster)
    per_t = r.reshape(r.shape[0], -1, n_in)
    return count_layer_instructions_from_events(
        int(per_t.astype(np.int64).sum()), per_t.shape[0] * per_t.shape[1],
        n_in, n_out, neuron)
