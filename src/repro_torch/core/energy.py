"""Instruction-level energy / delay / EDP model, calibrated to the silicon
(plain Python; the port keeps its own copy of the JAX package's module).

Calibration sources (all from the paper):
  * Per-instruction efficiency at point D (0.85 V / 200 MHz), 1 op = one
    11-bit instruction-cycle: AccW2V 0.99, AccV2V 1.18, ResetV 1.02,
    SpikeCheck 1.22 TOPS/W  ->  E/cycle = 1 / (TOPS/W) pJ.
  * Cross-check (validated in tests): the Fig. 6 neuron-update energies are
    reproduced by summing the sequence cycles: IF = SpikeCheck+ResetV =
    0.820+0.980 = 1.80 pJ (paper 1.81), LIF = 2.65 (2.67), RMP = 1.67 (1.68).
  * Table I operating points: (0.7 V, 66.67 MHz, 0.072 mW, 0.91 TOPS/W),
    (0.85 V, 200 MHz, 0.201 mW, 0.99), (1.2 V, 500 MHz, 0.88 mW, 0.57).
  * Area 0.089 mm^2, 54.2 % memory area efficiency, 65 nm.

The EDP-vs-sparsity curve (Fig. 11b) falls out analytically: per timestep a
macro executes 2*(1-s)*128 AccW2V cycles plus the neuron-update sequence, so
EDP(s)/EDP(0) = ((2*(1-s)*128 + u) / (2*128 + u))^2 with u the update cycles —
97.3 % reduction at s = 0.85 for RMP (paper: ~97.4 %).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.isa import MACRO_IN, MACRO_OUT, InstrCount

PJ = 1e-12


@dataclass(frozen=True)
class OperatingPoint:
    name: str
    vdd: float
    freq_hz: float
    power_w: float                  # measured average power, AccW2V
    accw2v_tops_w: float            # measured efficiency at this point


POINT_A = OperatingPoint("A(0.7V)", 0.70, 66.67e6, 0.072e-3, 0.91)
POINT_D = OperatingPoint("D(0.85V)", 0.85, 200e6, 0.201e-3, 0.99)
POINT_G = OperatingPoint("G(1.2V)", 1.20, 500e6, 0.88e-3, 0.57)
OPERATING_POINTS = (POINT_A, POINT_D, POINT_G)

# Per-instruction TOPS/W at point D (1 op = 1 cycle = one 11-bit instruction).
TOPS_W_D = {
    "acc_w2v": 0.99,
    "acc_v2v": 1.18,
    "reset_v": 1.02,
    "spike_check": 1.22,
}

AREA_MM2 = 0.089
MEM_AREA_EFFICIENCY = 0.542
TECH_NM = 65


def instr_energy_j(instr: str, point: OperatingPoint = POINT_D) -> float:
    """Energy per executed cycle of one instruction type, in joules."""
    e_at_d = PJ / TOPS_W_D[instr]
    # scale by the AccW2V efficiency ratio (relative instruction costs are
    # circuit-topology constants; supply/frequency scales them together)
    return e_at_d * (POINT_D.accw2v_tops_w / point.accw2v_tops_w)


def sequence_energy_j(counts: InstrCount, point: OperatingPoint = POINT_D) -> float:
    names = ("acc_w2v", "acc_v2v", "spike_check", "reset_v")
    return float(sum(getattr(counts, n) * instr_energy_j(n, point) for n in names))


def sequence_delay_s(counts: InstrCount, point: OperatingPoint = POINT_D) -> float:
    return counts.total / point.freq_hz


def sequence_edp(counts: InstrCount, point: OperatingPoint = POINT_D) -> float:
    return sequence_energy_j(counts, point) * sequence_delay_s(counts, point)


# Fig. 6 instruction sequences, one cycle per listed instruction (the paper's
# "energy/update" accounting; a full 12-neuron odd+even set update is 2x this).
NEURON_SEQ_COUNTS = {
    "if": InstrCount(spike_check=1, reset_v=1),
    "lif": InstrCount(acc_v2v=1, spike_check=1, reset_v=1),
    "rmp": InstrCount(spike_check=1, acc_v2v=1),
}
NEURON_UPDATE_COUNTS = {k: InstrCount(*(2 * x for x in v))
                        for k, v in NEURON_SEQ_COUNTS.items()}


def neuron_update_energy_pj(neuron: str, point: OperatingPoint = POINT_D) -> float:
    """Fig. 6 'Energy/update' numbers (pJ)."""
    return sequence_energy_j(NEURON_SEQ_COUNTS[neuron], point) / PJ


def timestep_counts(sparsity: float, neuron: str = "rmp", n_in: int = MACRO_IN) -> InstrCount:
    """Instruction cycles for one macro-timestep at a given input sparsity
    (0 -> all 128 input rows spike; 1 -> none)."""
    events = (1.0 - sparsity) * n_in
    acc = int(round(2 * events))                   # odd + even cycle per event
    upd = NEURON_UPDATE_COUNTS[neuron]
    return InstrCount(acc_w2v=acc) + upd


def edp_per_neuron_per_timestep(sparsity: float, neuron: str = "rmp",
                                point: OperatingPoint = POINT_D) -> float:
    """Fig. 11b: measured EDP per-neuron per-timestep vs sparsity."""
    c = timestep_counts(sparsity, neuron)
    return sequence_edp(c, point) / MACRO_OUT


def edp_reduction(sparsity: float, neuron: str = "rmp",
                  point: OperatingPoint = POINT_D) -> float:
    """Fractional EDP reduction vs the zero-sparsity case (paper: 0.974 @ 0.85)."""
    return 1.0 - edp_per_neuron_per_timestep(sparsity, neuron, point) \
               / edp_per_neuron_per_timestep(0.0, neuron, point)


def measured_edp(counts: InstrCount, point: OperatingPoint = POINT_D) -> float:
    """EDP of a *measured* instruction tally (J*s): the event-driven
    counterpart of the analytic Fig. 11b curve. The counts come from the
    execution pipeline (rasters or a `pipeline.SparsityReport`), so the EDP
    reflects the sparsity the workload actually exhibited rather than a
    swept parameter."""
    return sequence_edp(counts, point)


def measured_edp_per_neuron_timestep(counts: InstrCount, macro_timesteps: int,
                                     point: OperatingPoint = POINT_D) -> float:
    """Normalize a measured tally to the Fig. 11b axis: average instruction
    cycles per macro-timestep (``macro_timesteps`` =
    `SparsityReport.macro_timesteps`; conv layers contribute one macro-
    timestep per (timestep, example, output position) frame — the im2col
    lowering re-uses the grid per position), then EDP per neuron — directly
    comparable to `edp_per_neuron_per_timestep(s)` at the measured
    sparsity. Fractional average counts are fine: the energy/delay sums are
    linear in the per-instruction counts."""
    if macro_timesteps <= 0:
        raise ValueError("macro_timesteps must be positive")
    avg = InstrCount(*(c / macro_timesteps for c in counts))
    return sequence_edp(avg, point) / MACRO_OUT


def measured_edp_reduction(executed: InstrCount, skipped: InstrCount,
                           point: OperatingPoint = POINT_D) -> float:
    """Fractional EDP reduction a measured workload realized through
    event-driven skipping, at row granularity: ``executed`` is the tally
    the pipeline counted (`SparsityReport.instruction_counts`), ``skipped``
    the silent-row AccW2V cycles it never issued
    (`SparsityReport.skipped_instruction_counts` /
    `isa.count_skipped_instructions_from_events`). Their sum is the dense
    zero-sparsity tally, so this is the measured counterpart of
    `edp_reduction(s)` — Fig. 11b from executed event counts rather than a
    swept parameter, and tracking *row* skips (what the silicon skips)
    rather than tile-gate statistics."""
    dense = executed + skipped
    if dense.total == 0:
        raise ValueError("empty instruction tally (executed + skipped == 0)")
    return 1.0 - sequence_edp(executed, point) / sequence_edp(dense, point)


def tops_per_watt(point: OperatingPoint) -> float:
    """Throughput/power for AccW2V (1 op/cycle), Table I row."""
    return point.accw2v_tops_w


def gops_per_mm2(point: OperatingPoint) -> float:
    """Performance/Area, Table I row: 1 op per cycle over the macro area."""
    return point.freq_hz / 1e9 / AREA_MM2


def snn_energy_j(counts: InstrCount, point: OperatingPoint = POINT_D) -> float:
    """Total energy for an instruction-count tally of a full SNN inference."""
    return sequence_energy_j(counts, point)


def energy_per_inference_j(counts: InstrCount, batch: int,
                           point: OperatingPoint = POINT_D) -> float:
    """Per-example energy of an executed workload tally (counts measured
    over ``batch`` examples by `pipeline.count_network_instructions` — for
    conv programs these come from execution of the im2col-lowered program,
    not the analytic pass alone)."""
    if batch <= 0:
        raise ValueError("batch must be positive")
    return sequence_energy_j(counts, point) / batch
