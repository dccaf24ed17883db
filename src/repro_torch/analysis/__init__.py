"""Static verification of compiled SNN programs, before they run.

  * `check_program`: interval abstract interpretation of the word-level
    ISA; proves weights on the 6-bit grid, constants in the 11-bit V word
    and that no unclamped int32 accumulator can overflow (a per-layer
    `RangeReport` with the readout's ``max_safe_frames``, or a
    `RangeError` naming the layer).
  * `check_kernel_contracts`: the CUDA kernels' contracts of one dispatch
    (layers, lanes, event indices, gate columns, shared memory), decided
    by the same `kernels.fused_snn_net.kernel.launch_plan` the kernel
    wrapper calls (a `ContractReport`, or a `ContractError` naming the
    contract and the call).

`validate_program` runs both; `pipeline.compile_network(...,
validate=True)` (the default) calls it on every program it compiles, and
`serve.SNNServeEngine(validate=True)` runs both when it is built.
"""
from typing import Optional

from repro_torch.analysis.intervals import (INT32, V_DOMAIN, AnalysisError,
                                            Interval, clamp_interval,
                                            wrap_is_exact)
from repro_torch.analysis.kernel_contracts import (CUDA_BACKENDS,
                                                   ContractCheck,
                                                   ContractError,
                                                   ContractReport,
                                                   KernelCall,
                                                   check_kernel_contracts)
from repro_torch.analysis.program_check import (LayerRange, RangeError,
                                                RangeReport, check_program)

__all__ = [
    "AnalysisError", "CUDA_BACKENDS", "ContractCheck", "ContractError",
    "ContractReport", "INT32", "Interval", "KernelCall", "LayerRange",
    "RangeError", "RangeReport", "V_DOMAIN", "check_kernel_contracts",
    "check_program", "clamp_interval", "validate_program", "wrap_is_exact",
]


def validate_program(program, *, frames: Optional[int] = None) -> tuple:
    """Run the range pass and the kernel-contract pass; return
    ``(RangeReport, {backend: ContractReport}, {})`` and raise the first
    `AnalysisError` found. This is what `compile_network(...,
    validate=True)` executes at compile time.

    The contract checked is the dense ``cuda`` one for int-domain programs
    (the dispatch every integer backend shares its geometry with) and the
    trivial ``float`` one otherwise; a gated or event dispatch with its own
    knobs is checked by `check_kernel_contracts` directly. The third
    element, the trace pass's reports, stays empty: the port has no trace
    pass yet."""
    backend = "cuda" if program.domain == "int" else "float"
    ranges = check_program(program, frames=frames)
    contracts = {backend: check_kernel_contracts(program, backend,
                                                 frames=frames)}
    return ranges, contracts, {}
