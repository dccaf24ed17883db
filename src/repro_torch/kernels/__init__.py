"""Hand-written CUDA kernels for Hopper (``sm_90a``), one folder each:
``<name>/csrc/<name>.cu`` is the source, ``<name>/kernel.py`` its ctypes
binding, ``<name>/ops.py`` the public wrapper beside its plain PyTorch
version. One source may hold several kernels (``fused_snn_net.cu`` holds
the dense, gated and event-list kernels), each with its own count.
`_build.build` compiles a source with nvcc at first use.

``LAUNCH_COUNTS[name]`` counts the launches of kernel ``name``: its binding
adds one each time it launches the kernel and nowhere else, so a caller can
show that a run went through the kernel (reset with `reset_launch_counts`).
A CUDA graph (`repro_torch.serve.graphed`) launches kernels without running
their bindings: the launches of its warm-up and capture are not counted,
and each replay adds the launches its capture recorded, so a compiled
dispatch counts what the eager one counts.
"""

LAUNCH_COUNTS: dict = {"fused_snn_net": 0, "fused_snn_net_gated": 0,
                        "fused_snn_net_events": 0, "fused_snn_step": 0,
                        "wkv6": 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
