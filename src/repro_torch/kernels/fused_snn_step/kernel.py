"""ctypes binding of the CUDA fused SNN layer kernel
(``csrc/fused_snn_step.cu``), the Hopper counterpart of
`repro.kernels.fused_snn_step.kernel._snn_kernel`.

`fused_snn_step_cuda` checks every tensor (device, dtype, shape,
contiguity), lays out and checks the kernel's shared memory, allocates the
outputs, and launches one CTA per (``block_b`` lanes, ``block_n`` output
columns) tile on the current stream of the tensors' device. The library is
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
THREADS = 256
MAX_PER_THREAD = 32         # V elements a thread keeps in registers
SMEM_LIMIT = 232_448        # bytes of shared memory a Hopper block can use
MAX_GRID_N = 65_535         # the grid's y extent
NEURON_CODES = {"if": 0, "lif": 1, "rmp": 2}


class StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in the CUDA source (checked against the
    library's ``sizeof`` when it is loaded)."""
    _fields_ = [
        ("spikes", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("v_out", ctypes.c_void_p),
        ("timesteps", ctypes.c_int), ("batch", ctypes.c_int),
        ("n_in", ctypes.c_int), ("n_out", ctypes.c_int),
        ("block_b", ctypes.c_int), ("tile_n", ctypes.c_int),
        ("wt_ld", ctypes.c_int), ("spk_off", ctypes.c_int),
        ("spk_ld", ctypes.c_int), ("neuron", ctypes.c_int),
        ("wrap", ctypes.c_int), ("threshold", ctypes.c_int),
        ("leak", ctypes.c_int), ("reset", ctypes.c_int),
    ]


_LIB = None                 # the loaded library, built on first use


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(NAME)))
        lib.fused_snn_step_launch.argtypes = [ctypes.POINTER(StepArgs),
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
        lib.fused_snn_step_launch.restype = ctypes.c_int
        lib.fused_snn_step_error_string.argtypes = [ctypes.c_int]
        lib.fused_snn_step_error_string.restype = ctypes.c_char_p
        for fn in ("fused_snn_step_args_size", "fused_snn_step_threads",
                   "fused_snn_step_max_per_thread"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        built = (lib.fused_snn_step_args_size(), lib.fused_snn_step_threads(),
                 lib.fused_snn_step_max_per_thread())
        if built != (ctypes.sizeof(StepArgs), THREADS, MAX_PER_THREAD):
            raise RuntimeError(
                f"{NAME} library disagrees with its binding: (sizeof StepArgs, "
                f"threads, V per thread) = {built}, expected "
                f"{(ctypes.sizeof(StepArgs), THREADS, MAX_PER_THREAD)}")
        _LIB = lib
    return _LIB


def _odd_words(n_bytes: int) -> int:
    """32-bit words that hold ``n_bytes``, rounded up to an odd count so
    rows at that stride start in different shared-memory banks."""
    return -(-n_bytes // 4) | 1


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_layout(n_in: int, tile_n: int, block_b: int) -> dict:
    """Shared-memory layout of one CTA: the transposed W column tile
    (``tile_n`` rows of ``wt_ld`` words), then ``block_b`` spike rows of
    ``spk_ld`` words from ``spk_off``, and the total ``bytes``."""
    ld = _odd_words(n_in)
    spk_off = _align16(tile_n * ld * 4)
    return {"wt_ld": ld, "spk_off": spk_off, "spk_ld": ld,
            "bytes": spk_off + _align16(block_b * ld * 4)}


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
    wq (N_in, N_out) int8. A CTA covers ``block_b`` lanes and
    ``min(block_n, N_out)`` columns; ragged edges are masked.

    Returns (out_spikes (T, B, N_out) int8, v_final (B, N_out) int32).
    Raises `ValueError` on a tensor or option the kernel does not take
    (a tile of more than THREADS x MAX_PER_THREAD elements, or one whose
    shared memory exceeds a Hopper block's) and `RuntimeError` when the
    launch returns a CUDA error."""
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
    tile_n = min(block_n, n_out)
    if block_b < 1 or block_n < 1 or block_b * tile_n > THREADS * MAX_PER_THREAD:
        raise ValueError(
            f"a tile of block_b={block_b} lanes x {tile_n} columns must hold "
            f"1 to {THREADS * MAX_PER_THREAD} elements; lower block_b or "
            "block_n")
    _check_tensor(spikes, "spikes", torch.int8, (T, B, n_in), device)
    _check_tensor(wq, "wq", torch.int8, (n_in, n_out), device)
    layout = smem_layout(n_in, tile_n, block_b)
    if layout["bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"the {NAME} kernel needs {layout['bytes']} bytes of shared "
            f"memory for N_in={n_in}, {tile_n} columns and block_b={block_b}, "
            f"above the {SMEM_LIMIT} a Hopper block can use; lower block_n "
            "or block_b")
    grid_b, grid_n = -(-B // block_b), -(-n_out // tile_n)
    if grid_n > MAX_GRID_N:
        raise ValueError(f"{grid_n} column tiles exceed the grid's "
                         f"{MAX_GRID_N}; raise block_n")

    out = torch.empty((T, B, n_out), dtype=torch.int8, device=device)
    v_out = torch.empty((B, n_out), dtype=torch.int32, device=device)
    args = StepArgs(
        spikes=spikes.data_ptr(), w=wq.data_ptr(), out=out.data_ptr(),
        v_out=v_out.data_ptr(), timesteps=T, batch=B, n_in=n_in, n_out=n_out,
        block_b=block_b, tile_n=tile_n, wt_ld=layout["wt_ld"],
        spk_off=layout["spk_off"], spk_ld=layout["spk_ld"],
        neuron=NEURON_CODES[neuron], wrap=int(clamp_mode == "wrap"),
        threshold=int(threshold), leak=int(leak), reset=int(reset))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_snn_step_launch(ctypes.byref(args), grid_b, grid_n,
                                        layout["bytes"], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} "
                           f"({lib.fused_snn_step_error_string(err).decode()})")
    kernels.LAUNCH_COUNTS[NAME] += 1
    return out, v_out
