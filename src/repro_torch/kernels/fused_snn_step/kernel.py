"""ctypes binding of the CUDA fused SNN layer kernel
(``csrc/fused_snn_step.cu``), the Hopper counterpart of
`repro.kernels.fused_snn_step.kernel._snn_kernel`.

`fused_snn_step_cuda` checks every tensor (device, dtype, shape,
contiguity), picks the kernel's launch plan (`launch_plan`: its own CTA
tile of up to 8 lanes by 32 columns, the timesteps staged a chunk and the
buffering, from the shared-memory budget), allocates the outputs, and
launches on the current stream of the tensors' device. The library's own
plan is checked against `launch_plan` when it is loaded. The library is
built with nvcc on first use (`repro_torch.kernels._build`). Nothing here
runs on the CPU: the public wrapper `ops.fused_snn_layer` sends CPU tensors
to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

NAME = "fused_snn_step"
MAX_COLS = 32               # columns of a CTA: 4 warps of 8
MAX_LANES = 8               # lanes of a CTA: the MMA's 8 rows
TC_MAX = 16                 # timesteps of a chunk
SEG_SLACK = 48              # bytes the A loads read past the last row
SMEM_LIMIT = 232_448        # bytes of shared memory a Hopper block can use
MAX_GRID = 2 ** 31 - 1      # the grid's x extent
NEURON_CODES = {"if": 0, "lif": 1, "rmp": 2}
# shapes at which the library's plan is checked against `launch_plan` when
# it loads: (T, B, N_in, N_out)
PLAN_PROBES = ((120, 8, 100, 128), (10, 8, 128, 128), (1, 1, 100, 1),
               (10, 300, 686, 128), (7, 3, 30_000, 5), (2, 2, 100_000, 1))


class StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in the CUDA source (checked against the
    library's ``sizeof`` when it is loaded)."""
    _fields_ = [
        ("spikes", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("v_out", ctypes.c_void_p),
        ("timesteps", ctypes.c_int), ("batch", ctypes.c_int),
        ("n_in", ctypes.c_int), ("n_out", ctypes.c_int),
        ("lanes", ctypes.c_int), ("cols", ctypes.c_int),
        ("tc", ctypes.c_int), ("nbuf", ctypes.c_int),
        ("grid_b", ctypes.c_int), ("wt_ld", ctypes.c_int),
        ("spk_off", ctypes.c_int), ("seg_ld", ctypes.c_int),
        ("row_ld", ctypes.c_int),
        ("out_off", ctypes.c_int), ("out_ld", ctypes.c_int),
        ("neuron", ctypes.c_int), ("wrap", ctypes.c_int),
        ("threshold", ctypes.c_int), ("leak", ctypes.c_int),
        ("reset", ctypes.c_int),
    ]


_LIB = None                 # the loaded library, built on first use


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(NAME)))
        lib.fused_snn_step_launch.argtypes = [ctypes.POINTER(StepArgs),
                                              ctypes.c_int, ctypes.c_void_p]
        lib.fused_snn_step_launch.restype = ctypes.c_int
        lib.fused_snn_step_error_string.argtypes = [ctypes.c_int]
        lib.fused_snn_step_error_string.restype = ctypes.c_char_p
        lib.fused_snn_step_args_size.argtypes = []
        lib.fused_snn_step_args_size.restype = ctypes.c_int
        lib.fused_snn_step_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_snn_step_plan.restype = ctypes.c_int
        if lib.fused_snn_step_args_size() != ctypes.sizeof(StepArgs):
            raise RuntimeError(
                f"{NAME} library disagrees with its binding: sizeof StepArgs "
                f"{lib.fused_snn_step_args_size()}, expected "
                f"{ctypes.sizeof(StepArgs)}")
        for shape in PLAN_PROBES:
            got = (ctypes.c_int * 5)()
            err = lib.fused_snn_step_plan(*shape, got)
            plan = launch_plan(*shape)
            want = [plan[x] for x in ("lanes", "cols", "tc", "nbuf",
                                      "smem_bytes")]
            if err or list(got) != want:
                raise RuntimeError(
                    f"{NAME} library disagrees with its binding at (T, B, "
                    f"N_in, N_out) = {shape}: (lanes, cols, tc, nbuf, smem "
                    f"bytes) = {list(got)}, expected {want}")
        _LIB = lib
    return _LIB


def _odd_words(n_bytes: int) -> int:
    """32-bit words that hold ``n_bytes``, rounded up to an odd count so
    rows at that stride start in different shared-memory banks."""
    return -(-n_bytes // 4) | 1


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def row_ld(n_in: int) -> int:
    """Bytes of a staged lane row: N_in and its two ragged 16-byte blocks
    (N_in + 31), rounded up to 16 modulo 32, so that the 8 rows of an MMA
    tile fall in different shared-memory banks."""
    return (n_in + 46) // 32 * 32 + 16


def smem_layout(n_in: int, tile_n: int, block_b: int, tc: int = 1,
                nbuf: int = 1) -> dict:
    """Shared-memory layout of one CTA of ``block_b`` lanes by ``tile_n``
    columns staging ``tc`` timesteps a chunk in ``nbuf`` buffers: the
    transposed W column tile (``tile_n`` rows of ``wt_ld`` words, odd), then
    ``nbuf`` x ``tc`` staged steps of ``seg_ld`` bytes from ``spk_off``
    (each ``block_b`` lane rows of ``row_ld`` bytes, a row at its global
    offset modulo 16) and the `SEG_SLACK` bytes the MMA's A loads read past
    the last row, then the output tile (``tc`` x ``block_b`` rows of
    ``out_ld`` bytes) from ``out_off``, and the total ``bytes``."""
    ld = _odd_words(n_in)
    spk_off = _align16(tile_n * ld * 4)
    seg_ld = block_b * row_ld(n_in)
    out_off = spk_off + nbuf * tc * seg_ld + SEG_SLACK
    out_ld = _align16(tile_n)
    return {"wt_ld": ld, "spk_off": spk_off, "seg_ld": seg_ld,
            "row_ld": row_ld(n_in), "out_off": out_off, "out_ld": out_ld,
            "bytes": out_off + _align16(tc * block_b * out_ld)}


def launch_plan(T: int, B: int, n_in: int, n_out: int) -> dict | None:
    """The kernel's own CTA tile and chunking for a (T, B, N_in, N_out)
    layer: the widest column tile (32, 16, 8, then 4, 2, 1) at min(B, 8)
    lanes, then fewer lanes at one column; for each, the longest chunk
    (16, 8, 4, 2, 1 timesteps, at most T), double-buffered before
    single-buffered, whose `smem_layout` fits a Hopper block. Returns
    ``lanes``, ``cols``, ``tc``, ``nbuf``, ``threads`` (a warp per 8
    columns), ``grid_b`` x ``grid_n`` CTAs, the layout and ``smem_bytes``;
    None when nothing fits. `fused_snn_step_plan` in the CUDA source is its
    mirror."""
    lanes0 = min(B, MAX_LANES)
    cols = []
    for c in (32, 16, 8, 4, 2, 1):
        if not cols or cols[-1] != min(n_out, c):
            cols.append(min(n_out, c))
    cands = [(lanes0, c) for c in cols] + [(lanes, 1) for lanes in
                                          range(lanes0 - 1, 0, -1)]
    chunks = []
    for c in (16, 8, 4, 2, 1):
        if min(c, T) not in chunks:
            chunks.append(min(c, T))
    for lanes, n_cols in cands:
        for tc in chunks:
            for nbuf in (2, 1):
                if nbuf == 2 and tc >= T:           # one chunk: one buffer
                    continue
                lay = smem_layout(n_in, n_cols, lanes, tc, nbuf)
                if lay["bytes"] <= SMEM_LIMIT:
                    return {"lanes": lanes, "cols": n_cols, "tc": tc,
                            "nbuf": nbuf, "threads": 32 * -(-n_cols // 8),
                            "grid_b": -(-B // lanes),
                            "grid_n": -(-n_out // n_cols), **lay,
                            "smem_bytes": lay["bytes"]}
    return None


def _check_tensor(x: torch.Tensor, what: str, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, the spikes on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def fused_snn_step_cuda(spikes: torch.Tensor, wq: torch.Tensor, *,
                        threshold: int, leak: int, reset: int, neuron: str,
                        clamp_mode: str, block_b: int = 8,
                        block_n: int = 128) -> tuple:
    """Launch the kernel on CUDA tensors: spikes (T, B, N_in) int8 {0, 1},
    wq (N_in, N_out) int8. ``block_b`` and ``block_n`` are the JAX
    signature's tiling (checked, >= 1); the kernel's CTA tile comes from
    `launch_plan` and does not change results.

    Returns (out_spikes (T, B, N_out) int8, v_final (B, N_out) int32).
    Raises `ValueError` on a tensor or option the kernel does not take (or
    a fan-in whose smallest plan exceeds a Hopper block's shared memory)
    and `RuntimeError` when the launch returns a CUDA error."""
    device = spikes.device
    if device.type != "cuda":
        raise ValueError(f"the {NAME} kernel needs CUDA tensors, got spikes "
                         f"on {device}")
    if spikes.dim() != 3 or wq.dim() != 2:
        raise ValueError(f"spikes must be (T, B, N_in) and wq (N_in, N_out), "
                         f"got {tuple(spikes.shape)} and {tuple(wq.shape)}")
    T, B, n_in = spikes.shape
    n_out = wq.shape[1]
    if T < 1 or B < 1 or n_in < 1 or n_out < 1:
        raise ValueError(f"the kernel needs T, B, N_in, N_out >= 1, got "
                         f"{(T, B, n_in, n_out)}")
    if neuron not in NEURON_CODES or clamp_mode not in ("saturate", "wrap"):
        raise ValueError(f"unknown neuron {neuron!r} or clamp mode "
                         f"{clamp_mode!r}")
    if block_b < 1 or block_n < 1:
        raise ValueError(f"block_b and block_n must be >= 1, got {block_b}, "
                         f"{block_n}")
    _check_tensor(spikes, "spikes", torch.int8, (T, B, n_in), device)
    _check_tensor(wq, "wq", torch.int8, (n_in, n_out), device)
    plan = launch_plan(T, B, n_in, n_out)
    if plan is None:
        raise ValueError(
            f"the {NAME} kernel cannot fit one lane and one column of "
            f"N_in={n_in} in the {SMEM_LIMIT} bytes of shared memory a "
            "Hopper block can use")
    if plan["grid_b"] * plan["grid_n"] > MAX_GRID:
        raise ValueError(f"{plan['grid_b'] * plan['grid_n']} CTAs exceed the "
                         f"grid's {MAX_GRID}")

    out = torch.empty((T, B, n_out), dtype=torch.int8, device=device)
    v_out = torch.empty((B, n_out), dtype=torch.int32, device=device)
    args = StepArgs(
        spikes=spikes.data_ptr(), w=wq.data_ptr(), out=out.data_ptr(),
        v_out=v_out.data_ptr(), timesteps=T, batch=B, n_in=n_in, n_out=n_out,
        lanes=plan["lanes"], cols=plan["cols"], tc=plan["tc"],
        nbuf=plan["nbuf"], grid_b=plan["grid_b"], wt_ld=plan["wt_ld"],
        spk_off=plan["spk_off"], seg_ld=plan["seg_ld"],
        row_ld=plan["row_ld"], out_off=plan["out_off"],
        out_ld=plan["out_ld"],
        neuron=NEURON_CODES[neuron], wrap=int(clamp_mode == "wrap"),
        threshold=int(threshold), leak=int(leak), reset=int(reset))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_snn_step_launch(ctypes.byref(args),
                                        plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} "
                           f"({lib.fused_snn_step_error_string(err).decode()})")
    kernels.LAUNCH_COUNTS[NAME] += 1
    return out, v_out
