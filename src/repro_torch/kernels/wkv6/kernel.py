"""ctypes binding of the CUDA wkv6 kernel (``csrc/wkv6.cu``), the Hopper
counterpart of `repro.kernels.wkv6.kernel._wkv6_kernel`.

`wkv6_cuda` checks every tensor (device, dtype, shape, contiguity,
alignment), allocates the outputs, and launches the kernel on the current
stream of the tensors' device. `launch_plan` states the kernel's grid,
block and shared memory for a shape; the library's own plan is checked
against it for every (K, V) when the library is loaded. The library is
built with nvcc on first use (`repro_torch.kernels._build`). Nothing here
runs on the CPU: the public wrapper `ops.wkv6` sends CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_sequential

NAME = "wkv6"
HEAD_SIZES = (16, 32, 64)     # the K and V the kernel is instantiated for
CHUNK = 32                    # steps staged in shared memory at a time
ROWS = 4                      # state rows of a thread's tile
CPT = 4                       # state columns of a thread's tile
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block can use

_LIB = None                   # the loaded library, built on first use


def launch_plan(BH: int, K: int, V: int) -> dict:
    """The kernel's launch for B*H rows of K x V state: ``cols`` state
    columns a block, ``K / ROWS`` row groups of ``ROWS`` rows, each thread
    a tile of ``ROWS`` x ``CPT`` state elements (``threads`` = groups x
    cols / CPT), ``grid`` = BH x V / cols blocks, ``chunk`` steps staged at
    a time, and ``smem_bytes`` of dynamic shared memory: two stages of r,
    k, w (chunk x K each) and the block's v columns, and two partial-y
    buffers (groups x chunk x cols), float32."""
    cols = min(V, 32)
    groups = K // ROWS
    floats = 2 * (3 * CHUNK * K + CHUNK * cols) + 2 * groups * CHUNK * cols
    return {"grid": BH * (V // cols), "threads": groups * cols // CPT,
            "cols": cols, "groups": groups, "chunk": CHUNK,
            "smem_bytes": 4 * floats}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(NAME)))
        lib.wkv6_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.wkv6_launch.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib.wkv6_plan.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.wkv6_plan.restype = ctypes.c_int
        for K in HEAD_SIZES:
            for V in HEAD_SIZES:
                got = [ctypes.c_int() for _ in range(4)]
                err = lib.wkv6_plan(K, V, *map(ctypes.byref, got))
                plan = launch_plan(1, K, V)
                want = [plan[x] for x in ("threads", "cols", "smem_bytes",
                                          "chunk")]
                if err or [x.value for x in got] != want:
                    raise RuntimeError(
                        f"{NAME} library disagrees with its binding at K={K}, "
                        f"V={V}: (threads, cols, smem bytes, chunk) = "
                        f"{[x.value for x in got]}, expected {want}")
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, what: str, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, r on {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor) -> tuple:
    """Launch the kernel on CUDA float32 tensors: r, k, w (BH, T, K);
    v (BH, T, V); u (BH, K); s0 (BH, K, V). Returns (y (BH, T, V),
    s_out (BH, K, V)), float32.

    The launch is the custom operator ``torch.ops.repro_torch.wkv6``
    (`OP`): on fake tensors its fake implementation gives the outputs'
    shapes and launches nothing, and on DTensors it runs on each rank's
    shard of the B*H rows (or replicated).

    Raises `ValueError` on a tensor the kernel does not take (K or V outside
    `HEAD_SIZES`, T < 1, wrong device, dtype, shape or layout), and in grad
    mode on an input that requires a gradient: the kernel is forward-only
    and its outputs would carry no graph (`ops.wkv6(use_kernel=False)` is
    the differentiable route). `RuntimeError` when the launch returns a
    CUDA error."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, w, u, s0)):
        raise ValueError(f"the {NAME} kernel is forward-only and an input "
                         "requires a gradient; differentiate through "
                         "ops.wkv6(..., use_kernel=False)")
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"the {NAME} kernel needs CUDA tensors, got r on "
                         f"{device}")
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"r and v must be (BH, T, K/V), got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    if K not in HEAD_SIZES or V not in HEAD_SIZES:
        raise ValueError(f"the {NAME} kernel takes K and V in {HEAD_SIZES}, "
                         f"got K={K}, V={V}")
    if BH < 1 or T < 1:
        raise ValueError(f"the {NAME} kernel needs BH >= 1 and T >= 1, got "
                         f"BH={BH}, T={T}")
    for x, what, shape in ((r, "r", (BH, T, K)), (k, "k", (BH, T, K)),
                           (w, "w", (BH, T, K)), (v, "v", (BH, T, V)),
                           (u, "u", (BH, K)), (s0, "s0", (BH, K, V))):
        _check(x, what, shape, device)
    return OP(r, k, v, w, u, s0)


def _launch(r, k, v, w, u, s0) -> tuple:
    """`OP`'s CUDA implementation: the alignment check, the outputs, the
    launch on the current stream and its count."""
    for x, what in ((r, "r"), (k, "k"), (v, "v"), (w, "w"), (u, "u"),
                    (s0, "s0")):
        if x.data_ptr() % 16:
            raise ValueError(f"{what} must be contiguous and 16-byte "
                             "aligned")
    BH, T, K = r.shape
    V = v.shape[-1]
    device = r.device
    y = torch.empty((BH, T, V), dtype=torch.float32, device=device)
    s_out = torch.empty((BH, K, V), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                              y.data_ptr(), s_out.data_ptr(), BH, T, K, V,
                              stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} "
                           f"({lib.wkv6_error_string(err).decode()})")
    kernels.LAUNCH_COUNTS[NAME] += 1
    return y, s_out


def _fake(r, k, v, w, u, s0) -> tuple:
    """`OP`'s fake implementation: the outputs' shapes and type."""
    BH, T, K = r.shape
    V = v.shape[-1]
    return r.new_empty((BH, T, V)), r.new_empty((BH, K, V))


#: the launch as a custom operator, so that a trace on fake tensors (the
#: dry-run, `launch.dryrun`) records one node and launches nothing
OP = torch.library.custom_op(
    "repro_torch::wkv6", _launch, mutates_args=(), device_types="cuda",
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0)"
           " -> (Tensor, Tensor)")
OP.register_fake(_fake)
#: on the CPU the operator is the plain version: `ops.wkv6` takes it for
#: DTensors on a CPU mesh, which then run it on each rank's rows
OP.register_kernel("cpu")(wkv6_sequential)


def _register_sharding() -> None:
    """DTensor's rule for `OP`: every operand and both outputs replicated,
    or all sharded on the B*H rows, which the recurrence keeps apart."""
    import torch.distributed as dist
    if not dist.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.wkv6.default)
    def rule(r, k, v, w, u, s0):
        return [([Replicate()] * 2, [Replicate()] * 6),
                ([Shard(0)] * 2, [Shard(0)] * 6)]


_register_sharding()
