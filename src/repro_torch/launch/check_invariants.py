"""Repo invariant gate of the port: AST lint of the package, static analysis
of the two paper configs, and the trace matrix.

    python -m repro_torch.launch.check_invariants               # lint + analyze
    python -m repro_torch.launch.check_invariants --lint-only   # AST lint only
    python -m repro_torch.launch.check_invariants --analyze-only
    python -m repro_torch.launch.check_invariants --trace       # + trace matrix
    python -m repro_torch.launch.check_invariants --mesh        # + mesh rows

(from the repository root with ``PYTHONPATH=src``). Three parts:

  * lint: `analysis.lint` over ``src/repro_torch`` (ANA001 bare asserts,
    ANA002 ad-hoc V-word clamps, ANA003 unseeded randomness, ANA004
    undocumented API, ANA005 float casts in int-domain modules).
  * analyze: compile ``impulse-imdb`` and ``impulse-mnist`` (weights from
    seed 0, on the CPU) and run the range pass and the kernel-contract
    pass for every CUDA backend.
  * trace (``--trace``): `analysis.check_trace` of both programs on every
    int backend and surface, traced for the CPU and for a CUDA device (fake
    tensors: nothing runs, so no card is needed), then the cost model's
    dense instruction counts closed exactly against the executed pipeline
    counter.
  * mesh (``--mesh``): the mesh-execution contract rows (``mesh_axes`` and
    one ``mesh_split`` per call) of both programs on every CUDA backend
    for each of `MESH_SHAPES`, and the trace pass's mesh surface (each
    model rank's row-partial tick) on every int backend under
    `TRACE_MESH`, for the CPU and a CUDA device; dict-form meshes, so no
    process group is needed. With ``--trace`` the trace matrix runs every
    surface under `TRACE_MESH`.

Exit status 0 iff every check passes; each violation or error is printed
on its own line.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

LINT_ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_lint() -> int:
    """Lint the package; return the number of violations."""
    from repro_torch.analysis.lint import lint_paths
    violations = lint_paths([LINT_ROOT])
    for v in violations:
        print(v)
    print(f"lint: {len(violations)} violation(s) in {LINT_ROOT}")
    return len(violations)


def committed_programs():
    """(name, int program on the CPU) for the paper's two configs."""
    from repro_torch.configs.impulse_snn import IMDB, MNIST
    from repro_torch.core import pipeline, snn
    for name, cfg, init in (("imdb", IMDB, snn.init_fc_snn),
                            ("mnist", MNIST, snn.init_lenet_snn)):
        # validate=False: this tool is the validator; it reports a failure
        # with the config's name instead of dying inside compile_network
        yield name, pipeline.compile_network(
            cfg, init(0, cfg, device="cpu"), domain="int", validate=False,
            device="cpu")


def run_analysis(programs: list) -> int:
    """Range and contract passes of every program on every CUDA backend;
    return the number of failures."""
    from repro_torch.analysis import (CUDA_BACKENDS, AnalysisError,
                                      check_kernel_contracts, check_program)
    failures = 0
    for name, program in programs:
        try:
            ranges = check_program(program)
            contracts = {b: check_kernel_contracts(program, b)
                         for b in CUDA_BACKENDS}
        except AnalysisError as e:
            failures += 1
            print(f"analyze {name}: FAIL {type(e).__name__}: {e}")
            continue
        safe = ranges.max_safe_frames
        smem = max(r.smem_bytes for r in contracts.values())
        print(f"analyze {name}: ok — {len(ranges.layers)} layers in range "
              f"({program.clamp_mode}), max_safe_frames="
              f"{'unbounded' if safe is None else safe}, shared memory <= "
              f"{smem} B across {sorted(contracts)}")
    return failures


#: the mesh shapes the mesh contract rows are validated on
MESH_SHAPES = ({"data": 4, "model": 1}, {"data": 1, "model": 4},
               {"data": 2, "model": 2})
#: the mesh the trace pass's mesh surface is traced under
TRACE_MESH = {"data": 2, "model": 2}


def run_mesh(programs: list) -> int:
    """The mesh contract rows of every program on `MESH_SHAPES` and the
    mesh surface under `TRACE_MESH`; return the number of failures."""
    from repro_torch.analysis import (CUDA_BACKENDS, TRACE_BACKENDS,
                                      AnalysisError, check_kernel_contracts,
                                      check_trace)
    failures = 0
    for name, program in programs:
        for shape in MESH_SHAPES:
            for b in CUDA_BACKENDS:
                try:
                    rep = check_kernel_contracts(program, b, mesh=shape)
                except AnalysisError as e:
                    failures += 1
                    print(f"mesh {name} {shape} x {b}: FAIL "
                          f"{type(e).__name__}: {e}")
                    continue
                rows = [c for c in rep.checks
                        if c.contract in ("mesh_axes", "mesh_split")]
                if len(rows) != 1 + len(rep.calls):
                    failures += 1
                    print(f"mesh {name} {shape} x {b}: FAIL expected "
                          f"{1 + len(rep.calls)} mesh rows, got {len(rows)}")
                    continue
            print(f"mesh {name} {shape}: ok — {len(rows)} mesh-contract "
                  f"row(s) on each of {list(CUDA_BACKENDS)}")
        for device in ("cpu", "cuda"):
            for b in TRACE_BACKENDS:
                try:
                    rep = check_trace(program, b, surfaces=("mesh",),
                                      mesh=TRACE_MESH, device=device)
                except AnalysisError as e:
                    failures += 1
                    print(f"mesh trace {name} x {b} ({device}): FAIL "
                          f"{type(e).__name__}: {e}")
                    continue
                print(f"mesh trace {name} x {b} ({device}): ok — "
                      f"{len(rep.surfaces)} rank tick(s), "
                      f"{sum(s.reductions for s in rep.surfaces)} "
                      f"reduction(s) of unclamped partials")
    return failures


def run_trace(programs: list, mesh=None) -> int:
    """The trace matrix (every program x int backend x device, with the
    mesh surface under ``mesh`` when given) and the cost closure; return
    the number of failures."""
    from repro_torch.analysis import (TRACE_BACKENDS, AnalysisError,
                                      check_cost_closure, check_trace)
    failures = 0
    for name, program in programs:
        for device in ("cpu", "cuda"):
            for b in TRACE_BACKENDS:
                try:
                    rep = check_trace(program, b, device=device, mesh=mesh)
                except AnalysisError as e:
                    failures += 1
                    print(f"trace {name} x {b} ({device}): FAIL "
                          f"{type(e).__name__}: {e}")
                    continue
                launches = sum(len(s.launches) for s in rep.surfaces)
                print(f"trace {name} x {b} ({device}): ok — "
                      f"[{','.join(sorted({s.surface for s in rep.surfaces}))}]"
                      f" {len(rep.checks)} checks, {launches} kernel "
                      f"node(s), macs={rep.cost.macs}, "
                      f"hbm_bytes={rep.cost.hbm_bytes}")
        try:
            instr = check_cost_closure(program)
        except AnalysisError as e:
            failures += 1
            print(f"trace {name} closure: FAIL {type(e).__name__}: {e}")
            continue
        print(f"trace {name} closure: ok — {instr}")
    return failures


def main(argv=None) -> int:
    """Parse ``argv`` and run the requested parts; return the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--analyze-only", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="also trace both programs on every int backend and "
                         "close the static cost model")
    ap.add_argument("--mesh", action="store_true",
                    help="also check the mesh contract rows and the trace "
                         "pass's mesh surface")
    args = ap.parse_args(argv)
    n = 0
    if not args.analyze_only:
        n += run_lint()
    if not args.lint_only:
        programs = list(committed_programs())
        n += run_analysis(programs)
        if args.mesh:
            n += run_mesh(programs)
        if args.trace:
            n += run_trace(programs, TRACE_MESH if args.mesh else None)
    if n:
        return 1
    print("check_invariants: all clear")
    return 0


if __name__ == "__main__":
    sys.exit(main())
