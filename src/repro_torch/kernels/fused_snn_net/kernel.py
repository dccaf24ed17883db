"""ctypes binding of the CUDA fused-network kernels (``csrc/fused_snn_net.cu``),
the Hopper counterparts of `repro.kernels.fused_snn_net.kernel._net_kernel`
in its dense, row-block gated and event-list modes.

`fused_snn_net_cuda` checks every tensor (device, dtype, shape,
contiguity) and calls the mode's custom operator (`OPS`,
``torch.ops.repro_torch.fused_snn_net``, ``..._gated``, ``..._events``),
so that a traced dispatch (`repro_torch.analysis.check_trace`) shows each
launch as one named node. The operator takes the kernel's shared-memory
layout from `launch_plan` (the one function that decides which stacks the
kernels refuse, shared with `repro_torch.analysis.check_kernel_contracts`),
allocates the outputs, and launches on the current stream of the tensors'
device: in the gated and event-list modes one CTA per ``block_b`` batch
lanes, in the dense mode one CTA per `dense_plan` tile (its own lanes and
chunk of timesteps; the library's own plan, `csrc/dense_plan.h`, is
checked against `dense_plan` when it is loaded). The library is built with nvcc on first
use (`repro_torch.kernels._build`). Nothing here runs on the CPU: the
public wrapper `ops.fused_snn_net` sends CPU tensors to the plain version.

`skip_layout` and its constants are shared with the plain version: the
gate sites are blocks of 128/G logical fan-in rows (``LANE`` is the macro's
128-row fan-in here, not a hardware tile; the kernel pads no lanes).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

NAME = "fused_snn_net"
KERNEL_NAMES = {"dense": "fused_snn_net", "gated": "fused_snn_net_gated",
                "events": "fused_snn_net_events"}
MODE_CODES = {"dense": 0, "gated": 1, "events": 2}
LANE = 128                  # the macro's fan-in rows, the unit G divides
GATE_GRANULARITIES = (1, 2, 4, 8)
MAX_SKIP_COLS = 1024        # gate-site columns the skip output may carry
MAX_LAYERS = 16
THREADS = 256               # the gated kernel's block
EVENT_THREADS = 1024        # the event-list kernel's block
EVENT_TC_MAX = 16           # the longest event-list chunk, in timesteps
DENSE_THREADS = 256         # the dense kernel's block: 8 warps
DENSE_TC_MAX = 16           # the longest dense chunk, in timesteps
DENSE_SMS = 132             # CTAs the dense plan spreads lanes over (H100 SMs)
SMEM_LIMIT = 232_448        # bytes of shared memory a Hopper block can use
# stacks at which the library's dense plan is checked against `dense_plan`
# when it loads: (widths, T, B)
DENSE_PLAN_PROBES = (
    ((100, 128, 128, 1), 10, 32), ((100, 128, 128, 1), 10, 4096),
    ((100, 128, 128, 1), 120, 8), ((100, 128, 128, 1), 120, 4096),
    ((686, 120, 84, 10), 10, 64), ((126, 14), 10, 12_544),
    ((126, 14), 10, 3136), ((130, 24, 3), 1, 300), ((100,) + (32,) * 16, 33, 37),
    ((3000, 20), 5, 1), ((12_000, 4), 2, 9), ((100, 1000, 14, 1000, 10), 10, 8),
    ((14, 686, 14, 3000, 1), 10, 8), ((14, 4000, 1), 10, 8),
    ((14, 1500, 14, 4000, 1), 17, 37), ((14, 4000, 14, 2000, 1), 10, 8))
NEURON_CODES = {"if": 0, "lif": 1, "rmp": 2}
_PTRS = ctypes.c_void_p * MAX_LAYERS
_INTS = ctypes.c_int * MAX_LAYERS


class KernelRefused(ValueError):
    """A stack or option the kernels do not take; ``contract`` names the
    rule (`launch_plan`), which `analysis.kernel_contracts` reports."""

    def __init__(self, contract: str, message: str) -> None:
        super().__init__(message)
        self.contract = contract


class NetArgs(ctypes.Structure):
    """Mirror of ``struct NetArgs`` in the CUDA source (checked against the
    library's ``sizeof`` when it is loaded)."""
    _fields_ = [
        ("spikes", ctypes.c_void_p),
        ("w", _PTRS), ("v_init", _PTRS), ("v_out", _PTRS), ("raster", _PTRS),
        ("width", ctypes.c_int * (MAX_LAYERS + 1)),
        ("threshold", _INTS), ("leak", _INTS),
        ("wt_off", _INTS), ("wt_ld", _INTS), ("v_off", _INTS),
        ("spk_off", ctypes.c_int * 2), ("spk_ld", ctypes.c_int),
        ("n_layers", ctypes.c_int), ("n_spiking", ctypes.c_int),
        ("timesteps", ctypes.c_int), ("batch", ctypes.c_int),
        ("block_b", ctypes.c_int), ("neuron", ctypes.c_int),
        ("wrap", ctypes.c_int), ("emit_rasters", ctypes.c_int),
        ("has_v_init", ctypes.c_int),
        ("cnt_off", ctypes.c_int), ("n_counters", ctypes.c_int),
        ("gate_bw", ctypes.c_int), ("skip_off", _INTS),
        ("n_skip_cols", ctypes.c_int), ("gate_off", ctypes.c_int),
        ("gate_ld", ctypes.c_int), ("skips", ctypes.c_void_p),
        ("row_off", _INTS), ("fb_off", ctypes.c_int), ("dense_thr", _INTS),
        ("list_off", ctypes.c_int), ("list_ld", ctypes.c_int),
        ("lcount_off", ctypes.c_int), ("row_counts", _PTRS),
        ("fallbacks", ctypes.c_void_p), ("tc", ctypes.c_int),
        ("chunk_off", ctypes.c_int * 2), ("chunk_ld", ctypes.c_int),
        ("ttot_off", ctypes.c_int), ("in_off", ctypes.c_int),
        ("in_ld", ctypes.c_int), ("out_off", ctypes.c_int * 2),
        ("out_ld", ctypes.c_int * 2), ("counts_off", ctypes.c_int),
        ("counts_ld", ctypes.c_int),
    ]


_LIB = None                 # the loaded library, built on first use


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(NAME)))
        lib.fused_snn_net_launch.argtypes = [ctypes.POINTER(NetArgs),
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
        lib.fused_snn_net_launch.restype = ctypes.c_int
        lib.fused_snn_net_error_string.argtypes = [ctypes.c_int]
        lib.fused_snn_net_error_string.restype = ctypes.c_char_p
        for fn in ("fused_snn_net_args_size", "fused_snn_net_threads",
                   "fused_snn_net_max_layers", "fused_snn_net_event_threads",
                   "fused_snn_net_dense_threads"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        built = (lib.fused_snn_net_args_size(), lib.fused_snn_net_threads(),
                 lib.fused_snn_net_max_layers(),
                 lib.fused_snn_net_event_threads(),
                 lib.fused_snn_net_dense_threads())
        want = (ctypes.sizeof(NetArgs), THREADS, MAX_LAYERS, EVENT_THREADS,
                DENSE_THREADS)
        if built != want:
            raise RuntimeError(
                f"{NAME} library disagrees with its binding: (sizeof NetArgs, "
                f"threads, max layers, event-list threads, dense threads) = "
                f"{built}, expected {want}")
        check_dense_plan(lib)
        _LIB = lib
    return _LIB


def c_dense_plan(lib: ctypes.CDLL, widths: tuple, T: int, B: int):
    """The library's `fused_snn_net_dense_plan` for a stack, in the layout
    of `dense_plan` (the keys the kernel takes), or None when it plans
    nothing. ``lib`` is any library that holds ``csrc/dense_plan.h``."""
    fn = lib.fused_snn_net_dense_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    L = len(widths) - 1
    out = (ctypes.c_int * (11 + 3 * MAX_LAYERS))()
    if fn(L, (ctypes.c_int * len(widths))(*widths), T, B, out) != 0:
        return None
    head = dict(zip(("lanes", "tc", "bytes", "in_off", "in_ld"), out[:5]))
    per = [list(out[11 + k * MAX_LAYERS:11 + k * MAX_LAYERS + L])
           for k in range(3)]
    return {**head, "out_off": list(out[5:7]), "out_ld": list(out[7:9]),
            "counts_off": out[9], "counts_ld": out[10], "wt_off": per[0],
            "wt_ld": per[1], "v_off": per[2]}


def check_dense_plan(lib: ctypes.CDLL) -> None:
    """Raise `RuntimeError` unless the library's dense plan equals
    `dense_plan` on every stack of `DENSE_PLAN_PROBES`."""
    for widths, T, B in DENSE_PLAN_PROBES:
        got = c_dense_plan(lib, widths, T, B)
        plan = dense_plan(widths, T, B)
        if got is None or plan is None or got != {k: plan[k] for k in got}:
            raise RuntimeError(
                f"{NAME} library disagrees with its binding on the dense "
                f"plan of widths {widths} at T={T}, B={B}: {got}, expected "
                f"{plan}")


def _odd_words(n_bytes: int) -> int:
    """32-bit words that hold ``n_bytes``, rounded up to an odd count so
    rows at that stride start in different shared-memory banks."""
    return -(-n_bytes // 4) | 1


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def skip_layout(in_widths: tuple, granularity: int
                ) -> tuple[tuple, tuple, int]:
    """Column map of the gated mode's skip counts: gate site (layer i,
    block g) reports in column ``offsets[i] + g``.

    ``in_widths``: per-layer logical input widths. At granularity 1 every
    layer is one gate (one column per layer); at G in {2, 4, 8} layer i has
    ceil(width / (128/G)) blocks of 128/G fan-in rows, the last one ragged.
    Returns (columns per layer, column offsets per layer, total columns).
    Raises `KernelRefused` (a `ValueError`) for a granularity outside
    `GATE_GRANULARITIES` or a layout above ``MAX_SKIP_COLS`` columns."""
    if granularity not in GATE_GRANULARITIES:
        raise KernelRefused("gate_granularity",
                            f"gate granularity must be one of "
                            f"{GATE_GRANULARITIES}, got {granularity}")
    if granularity == 1:
        n_cols = tuple(1 for _ in in_widths)
    else:
        bw = LANE // granularity
        n_cols = tuple(-(-w // bw) for w in in_widths)
    total = sum(n_cols)
    if total > MAX_SKIP_COLS:
        raise KernelRefused(
            "skip_layout",
            f"skip-count layout needs {total} gate columns "
            f"({len(in_widths)} layers at granularity {granularity}) but the "
            f"output carries at most MAX_SKIP_COLS={MAX_SKIP_COLS}; lower "
            "the granularity or split the stack")
    offsets, off = [], 0
    for n in n_cols:
        offsets.append(off)
        off += n
    return n_cols, tuple(offsets), total


def dense_thresholds(in_widths: tuple, block_b: int,
                     event_crossover: float) -> tuple:
    """Per-layer event count of a tile above which the event-list mode
    takes the dense product: ``int(crossover * block_b * width)``, or -1 at
    crossover 0 (the test is strict ``>``, so 1.0 never trips and 0.0
    always does). A ragged tile keeps the full ``block_b`` capacity."""
    return tuple(int(event_crossover * block_b * w) if event_crossover > 0.0
                 else -1 for w in in_widths)


def smem_layout(widths: tuple, block_b: int, mode: str = "dense",
                n_skip_cols: int = 0, tc: int = 1) -> dict:
    """Shared-memory layout of one CTA for logical layer ``widths``
    (N_0 .. N_L), ``block_b`` lanes and kernel ``mode``: each layer's
    transposed weights (``wt_off``/``wt_ld``), each layer's int32 V tile
    (``v_off``), the two int8 spike buffers (``spk_off``/``spk_ld``), the
    int32 counters (``cnt_off``, ``n_counters``: the ``n_skip_cols`` skip
    columns in gated mode; in event-list mode each layer's input-row
    counts from ``row_off[i]`` and one fallback count per layer from
    ``fb_off``), the gated mode's occupancy masks (``gate_off``: one
    32-bit word per 128 fan-in rows of the widest layer, ``gate_ld``, for
    each of the block's warps), and the event-list mode's chunk of ``tc``
    timesteps: the uint16 active-row lists of its (t, lane) rows
    (``list_off``, ``list_ld`` entries each, the widest fan-in rounded up
    to 8 so that 8 entries are one 16-byte load) and their int32 lengths
    (``lcount_off``), the two chunk buffers of ``tc`` steps of
    ``chunk_ld`` bytes (``chunk_off``; at ``tc`` = 1 they are the spike
    buffers themselves) and two rows of per-step event totals
    (``ttot_off``); and the total ``bytes``. The one place the kernels'
    shared memory is computed."""
    off = 0
    wt_off, wt_ld, v_off = [], [], []
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        wt_off.append(off)
        wt_ld.append(_odd_words(n_in))
        off += _align16(n_out * wt_ld[-1] * 4)
    for n_out in widths[1:]:
        v_off.append(off)
        off += _align16(block_b * n_out * 4)
    spk_ld = _odd_words(max(widths))
    spk_bytes = _align16(block_b * spk_ld * 4)
    spk_off = [off, off + spk_bytes]
    off += 2 * spk_bytes
    in_widths = widths[:-1]
    row_off, fb_off, list_ld = [], 0, 0
    events = mode == "events"
    if mode == "gated":
        n_counters = n_skip_cols
    elif events:
        for n_in in in_widths:
            row_off.append(fb_off)
            fb_off += n_in
        n_counters = fb_off + len(in_widths)
        list_ld = -(-max(in_widths) // 8) * 8
    else:
        n_counters = 0
    cnt_off = off
    off += _align16(4 * n_counters)
    gate_off = off
    gate_ld = -(-max(in_widths) // LANE) if mode == "gated" else 0
    off += _align16(4 * (THREADS // 32) * gate_ld)
    list_off = off
    off += _align16(2 * tc * block_b * list_ld)
    lcount_off = off
    off += _align16(4 * tc * block_b) if events else 0
    chunk_off = spk_off
    if events and tc > 1:
        chunk_off = [off, off + tc * spk_bytes]
        off += 2 * tc * spk_bytes
    ttot_off = off
    off += _align16(4 * 2 * tc) if events else 0
    return {"wt_off": wt_off, "wt_ld": wt_ld, "v_off": v_off,
            "spk_off": spk_off, "spk_ld": spk_ld, "cnt_off": cnt_off,
            "n_counters": n_counters, "row_off": row_off, "fb_off": fb_off,
            "gate_off": gate_off, "gate_ld": gate_ld,
            "list_off": list_off, "list_ld": list_ld,
            "lcount_off": lcount_off, "tc": tc, "chunk_off": chunk_off,
            "chunk_ld": spk_bytes, "ttot_off": ttot_off, "bytes": off}


def event_layout(widths: tuple, block_b: int, timesteps: int) -> dict:
    """The event-list kernel's layout for ``timesteps`` frames: the longest
    chunk, at most `EVENT_TC_MAX` and the frames there are, whose
    `smem_layout` fits a Hopper block, down to one timestep (which may
    still not fit: the caller checks ``bytes``)."""
    for tc in range(min(EVENT_TC_MAX, max(timesteps, 1)), 0, -1):
        lay = smem_layout(widths, block_b, "events", tc=tc)
        if lay["bytes"] <= SMEM_LIMIT or tc == 1:
            return lay


def _kstep_row(n: int) -> int:
    """Bytes of a shared-memory row that the MMA k-steps read ``n`` bytes
    of: whole 16-byte blocks, an odd number of them (16 mod 32 bytes, so
    the 8 rows of an MMA fragment fall in different banks)."""
    blocks = -(-n // 16)
    return 16 * (blocks + (blocks % 2 == 0))


def _in_row(n0: int) -> int:
    """Bytes of a staged input row: N0 and the two ragged 16-byte blocks a
    row at any offset touches (N0 + 31), rounded up to 16 mod 32."""
    return (n0 + 46) // 32 * 32 + 16


def dense_layout(widths: tuple, lanes: int, tc: int,
                 compact: bool = False, counts: bool = True) -> dict:
    """The dense kernel's shared memory for ``lanes`` lanes and chunks of
    ``tc`` timesteps, in order: every layer's transposed weights
    (``wt_off``, rows of ``wt_ld`` words: `_kstep_row` of the fan-in, or
    with ``compact`` the odd word count of the gated layout, whose B loads
    meet bank conflicts; the bytes past the fan-in are masked where they
    are read; regions padded to 16 bytes), the input chunk (``in_off``,
    tc x lanes rows of ``in_ld`` bytes, a row at its global offset modulo
    16), the two spike chunks (``out_off``, tc x lanes rows each; chunk k
    holds the outputs of the layers i with i % 2 == k, in rows of
    ``out_ld[k]`` bytes; the second only with two layers or more), the
    counts (``counts_off``, lanes rows of ``counts_ld`` bytes with two
    layers or more and ``counts``: layer L - 2's spike counts over the
    chunk, a readout's input; else ``counts_ld`` is 0 and a readout sums
    its input's spike rows) and
    every layer's int32 V tile (``v_off``, lanes x N_{i+1}) and 16 bytes of
    slack; and the total ``bytes``. Every offset is a multiple of 16, and
    the k-steps' reads past a region's last row (up to 16 bytes past a
    spike or counts row, 28 past a weight row) land in the next region or
    the slack.
    `csrc/dense_plan.h` is its mirror."""
    n_layers = len(widths) - 1
    off, wt_off, wt_ld = 0, [], []
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        wt_off.append(off)
        wt_ld.append(_odd_words(n_in) if compact else _kstep_row(n_in) // 4)
        off += _align16(n_out * 4 * wt_ld[-1])
    in_off, in_ld = off, _in_row(widths[0])
    off += tc * lanes * in_ld
    out_off, out_ld = [], []
    for k in (0, 1):
        out_off.append(off)
        out_ld.append(_kstep_row(max(widths[k + 1::2], default=1)))
        if k == 0 or n_layers > 1:
            off += tc * lanes * out_ld[-1]
    counts_off = off
    counts_ld = _kstep_row(widths[-2]) if n_layers > 1 and counts else 0
    off += lanes * counts_ld
    v_off = []
    for n_out in widths[1:]:
        v_off.append(off)
        off += 4 * lanes * n_out
    off = _align16(off) + 16                    # the slack
    return {"lanes": lanes, "tc": tc, "compact": compact, "counts": counts,
            "wt_off": wt_off, "wt_ld": wt_ld, "in_off": in_off,
            "in_ld": in_ld, "out_off": out_off, "out_ld": out_ld,
            "counts_off": counts_off, "counts_ld": counts_ld, "v_off": v_off,
            "bytes": off}


def dense_plan(widths: tuple, T: int, B: int) -> dict | None:
    """The dense kernel's own tile for a (T, B) call of logical layer
    ``widths``: ceil(B / 8) lane groups of 8 (an MMA row tile is two
    timesteps of 8 lanes) spread over at most `DENSE_SMS` CTAs, and the
    longest chunk (16, 8, 4, 2, 1 timesteps, at most T), then the most lane
    groups, whose `dense_layout` fits a Hopper block; where none does, the
    same with compact weight rows, then also without the readout's counts,
    then with 4, 2 or 1 lanes (an MMA tile's rows past them read the last
    lane and store nothing). Results do not depend on the tile. Returns the
    layout with ``grid`` and ``threads``, or None when not even one lane
    and one timestep fit."""
    groups = -(-B // 8)
    want = max(1, -(-groups // DENSE_SMS))
    chunks = []
    for c in (DENSE_TC_MAX, 8, 4, 2, 1):
        if min(c, max(T, 1)) not in chunks:
            chunks.append(min(c, max(T, 1)))
    tiles = [(8 * groups, tc, compact, counts)
             for compact, counts in ((False, True), (True, True),
                                     (True, False))
             for tc in chunks for groups in range(want, 0, -1)]
    tiles += [(lanes, tc, True, False) for lanes in (4, 2, 1)
              for tc in chunks]
    for lanes, tc, compact, counts in tiles:
        lay = dense_layout(widths, lanes, tc, compact, counts)
        if lay["bytes"] <= SMEM_LIMIT:
            return {**lay, "grid": -(-B // lanes), "threads": DENSE_THREADS}
    return None


def launch_plan(widths: tuple, T: int, B: int, *, mode: str = "dense",
                block_b: int = 8, gate_granularity: int = 1,
                neuron: str = "rmp", clamp_mode: str = "saturate") -> dict:
    """The launch of a (T, B) call of logical layer ``widths`` (N_0 ..
    N_L) in kernel ``mode``, or the rule that refuses it: the one place
    the kernels' refusals are decided. It takes no device and no tensors:
    `fused_snn_net_cuda` calls it before every launch and
    `analysis.check_kernel_contracts` before a program runs.

    Returns ``layout`` (`dense_plan`, `smem_layout` or `event_layout`),
    ``lanes`` (a CTA's lanes: the dense plan's, else ``block_b``),
    ``grid`` and the gated mode's ``skip_off``/``n_skip_cols``
    (`skip_layout`; () and 0 in the other modes). Raises `KernelRefused`
    naming the first rule broken, in this order: ``mode``,
    ``gate_granularity``/``skip_layout`` (the gated mode's `skip_layout`,
    which `ops.fused_snn_net` checks before it reaches this function),
    ``max_layers`` (1 to `MAX_LAYERS` layers), ``batch``, ``block_b`` (1
    to 1,024), ``neuron``, ``event_index`` (event-list fan-in below 2**16)
    and ``smem_budget`` (the layout above `SMEM_LIMIT`)."""
    if mode not in MODE_CODES:
        raise KernelRefused("mode", f"unknown kernel mode {mode!r}; have "
                                    f"{tuple(MODE_CODES)}")
    skip_off, n_skip_cols = (), 0
    if mode == "gated":     # first, as the public wrapper checks it first
        _, skip_off, n_skip_cols = skip_layout(widths[:-1], gate_granularity)
    n_layers = len(widths) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise KernelRefused("max_layers", f"the kernel takes 1 to "
                                          f"{MAX_LAYERS} layers, got "
                                          f"{n_layers}")
    if B < 1:
        raise KernelRefused("batch", "the kernel needs a batch of at least "
                                     "one lane")
    if not 1 <= block_b <= 1024:
        raise KernelRefused("block_b", f"block_b must lie in [1, 1024], got "
                                       f"{block_b}")
    if neuron not in NEURON_CODES or clamp_mode not in ("saturate", "wrap"):
        raise KernelRefused("neuron", f"unknown neuron {neuron!r} or clamp "
                                      f"mode {clamp_mode!r}")
    if mode == "events" and max(widths[:-1]) > 65535:
        raise KernelRefused("event_index", "the event-list kernel indexes "
                                           "fan-in rows with 16 bits")
    lanes = block_b
    if mode == "dense":
        layout = dense_plan(widths, T, B)
        if layout is None:
            raise KernelRefused(
                "smem_budget",
                f"the {NAME} kernel cannot fit one lane and one timestep of "
                f"widths {widths} in the {SMEM_LIMIT} bytes of shared memory "
                "a Hopper block can use")
        lanes = layout["lanes"]
    else:
        layout = (event_layout(widths, block_b, T) if mode == "events" else
                  smem_layout(widths, block_b, mode, n_skip_cols))
        if layout["bytes"] > SMEM_LIMIT:
            raise KernelRefused(
                "smem_budget",
                f"the {NAME} kernel needs {layout['bytes']} bytes of shared "
                f"memory for widths {widths} at block_b={block_b} in {mode} "
                f"mode, above the {SMEM_LIMIT} a Hopper block can use; lower "
                "block_b")
    return {"layout": layout, "lanes": lanes, "grid": -(-B // lanes),
            "skip_off": skip_off, "n_skip_cols": n_skip_cols}


@functools.lru_cache(maxsize=1024)
def _plan(widths: tuple, T: int, B: int, mode: str, block_b: int,
          gate_granularity: int, neuron: str, clamp_mode: str) -> dict:
    """`launch_plan`, memoized for the launches of a serving loop, which
    repeat a few geometries (the wrapper and the operator each ask for
    it). Callers only read the plan."""
    return launch_plan(widths, T, B, mode=mode, block_b=block_b,
                       gate_granularity=gate_granularity, neuron=neuron,
                       clamp_mode=clamp_mode)


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


def fused_snn_net_cuda(spikes: torch.Tensor, ws: list, thresholds: tuple,
                       leaks: tuple, *, neuron: str, clamp_mode: str,
                       readout: bool, emit_rasters: bool, v_init: list = None,
                       block_b: int = 8, mode: str = "dense",
                       gate_granularity: int = 1,
                       event_crossover: float = 1.0) -> tuple:
    """Launch the kernel of ``mode`` ("dense", "gated" or "events") on CUDA
    tensors: spikes (T, B, N0) int8 {0, 1}; ``ws[i]`` (N_i, N_{i+1}) int8,
    spiking layers first and the readout last when ``readout``; one int
    threshold and leak per spiking layer; optional ``v_init[i]``
    (B, N_{i+1}) int32 carried state. ``gate_granularity`` sets the gated
    mode's blocks (`skip_layout`) and ``event_crossover`` the event-list
    mode's dense fallback (`dense_thresholds`).

    The launch is one call of the mode's custom operator (`OPS`,
    ``torch.ops.repro_torch.<kernel name>``), so a traced dispatch shows it
    as one named node: on fake tensors the operator's fake implementation
    checks `launch_plan` and makes the outputs' shapes, and nothing
    launches or loads the library.

    Returns (rasters, v_finals, counters): (T, B, N_{i+1}) int8 per spiking
    layer ([] without ``emit_rasters``), (B, N_{i+1}) int32 per layer, and
    None in dense mode; in gated mode the (tiles, total columns) int32 skip
    counts; in event-list mode the pair (per-layer (tiles, N_i) int32 row
    event counts, (tiles, n_layers) int32 fallback counts). A tile of the
    counters is ``block_b`` lanes; the dense mode checks ``block_b`` but
    takes its CTA tile from `dense_plan`.

    Raises `ValueError` on a tensor the kernel does not take,
    `KernelRefused` (a `ValueError`) on a stack or option `launch_plan`
    refuses, and `RuntimeError` when the launch returns a CUDA error."""
    device = spikes.device
    if device.type != "cuda":
        raise ValueError(f"the {NAME} kernel needs CUDA tensors, got spikes "
                         f"on {device}")
    if spikes.dim() != 3:
        raise ValueError(f"spikes must be (T, B, N0), got {tuple(spikes.shape)}")
    T, B, N0 = spikes.shape
    widths = (N0,) + tuple(w.shape[1] for w in ws)
    _plan(widths, T, B, mode, block_b, gate_granularity, neuron, clamp_mode)
    n_spiking = len(ws) - 1 if readout else len(ws)
    _check_tensor(spikes, "spikes", torch.int8, (T, B, N0), device)
    for i, w in enumerate(ws):
        _check_tensor(w, f"ws[{i}]", torch.int8, (widths[i], widths[i + 1]),
                      device)
    if v_init is not None:
        for i, v in enumerate(v_init):
            _check_tensor(v, f"v_init[{i}]", torch.int32,
                          (B, widths[i + 1]), device)
    out = OPS[mode](spikes, list(ws), [] if v_init is None else list(v_init),
                    [int(t) for t in thresholds[:n_spiking]],
                    [int(lk) for lk in leaks[:n_spiking]], neuron,
                    clamp_mode, readout, emit_rasters, block_b,
                    gate_granularity, float(event_crossover))
    rasters, v_out = list(out[0]), list(out[1])
    counters = (None if mode == "dense" else out[2] if mode == "gated"
                else (list(out[2]), out[3]))
    return rasters, v_out, counters


def _op_outputs(mode: str, spikes, ws, readout, emit_rasters, block_b,
                gate_granularity, neuron, clamp_mode) -> tuple:
    """`launch_plan` of one operator call and fresh outputs in the
    operator's return layout: rasters, V, then the gated skip counts or
    the event-list row and fallback counts of the plan's tiles."""
    T, B, N0 = spikes.shape
    widths = (N0,) + tuple(w.shape[1] for w in ws)
    plan = _plan(widths, T, B, mode, block_b, gate_granularity, neuron,
                 clamp_mode)
    grid = plan["grid"]
    n_spiking = len(ws) - 1 if readout else len(ws)
    v_out = [spikes.new_empty((B, n), dtype=torch.int32) for n in widths[1:]]
    rasters = ([spikes.new_empty((T, B, n), dtype=torch.int8)
                for n in widths[1:n_spiking + 1]] if emit_rasters else [])
    if mode == "dense":
        return plan, (rasters, v_out)
    if mode == "gated":
        return plan, (rasters, v_out, spikes.new_empty(
            (grid, plan["n_skip_cols"]), dtype=torch.int32))
    return plan, (rasters, v_out,
                  [spikes.new_empty((grid, n), dtype=torch.int32)
                   for n in widths[:-1]],
                  spikes.new_empty((grid, len(ws)), dtype=torch.int32))


def _launch(mode: str, spikes, ws, v_init, thresholds, leaks, neuron,
            clamp_mode, readout, emit_rasters, block_b, gate_granularity,
            event_crossover) -> tuple:
    """The operators' CUDA implementation: fill `NetArgs` from the plan and
    the tensors, launch on the current stream and count the launch."""
    device = spikes.device
    T, B, N0 = spikes.shape
    widths = (N0,) + tuple(w.shape[1] for w in ws)
    plan, out = _op_outputs(mode, spikes, ws, readout, emit_rasters,
                            block_b, gate_granularity, neuron, clamp_mode)
    rasters, v_out = out[0], out[1]
    n_layers = len(ws)
    n_spiking = n_layers - 1 if readout else n_layers
    layout, lanes = plan["layout"], plan["lanes"]
    n_skip_cols, skip_off = plan["n_skip_cols"], plan["skip_off"]
    args = NetArgs()
    args.spikes = spikes.data_ptr()
    for i in range(n_layers):
        args.w[i] = ws[i].data_ptr()
        args.v_out[i] = v_out[i].data_ptr()
        if v_init:
            args.v_init[i] = v_init[i].data_ptr()
        args.wt_off[i] = layout["wt_off"][i]
        args.wt_ld[i] = layout["wt_ld"][i]
        args.v_off[i] = layout["v_off"][i]
    for i in range(n_spiking):
        args.threshold[i] = int(thresholds[i])
        args.leak[i] = int(leaks[i])
    for i, r in enumerate(rasters):
        args.raster[i] = r.data_ptr()
    for i, n in enumerate(widths):
        args.width[i] = n
    args.n_layers, args.n_spiking = n_layers, n_spiking
    args.timesteps, args.batch, args.block_b = T, B, lanes
    args.neuron = NEURON_CODES[neuron]
    args.wrap = int(clamp_mode == "wrap")
    args.emit_rasters = int(emit_rasters)
    args.has_v_init = int(bool(v_init))
    if mode == "dense":
        args.tc, args.in_off, args.in_ld = (layout["tc"], layout["in_off"],
                                            layout["in_ld"])
        args.out_off[0], args.out_off[1] = layout["out_off"]
        args.out_ld[0], args.out_ld[1] = layout["out_ld"]
        args.counts_off = layout["counts_off"]
        args.counts_ld = layout["counts_ld"]
    else:
        args.spk_off[0], args.spk_off[1] = layout["spk_off"]
        args.spk_ld = layout["spk_ld"]
        args.cnt_off = layout["cnt_off"]
        args.n_counters = layout["n_counters"]
        args.list_off, args.list_ld = layout["list_off"], layout["list_ld"]
        args.lcount_off = layout["lcount_off"]
    if mode == "gated":
        args.gate_bw = 0 if gate_granularity == 1 else LANE // gate_granularity
        for i, off in enumerate(skip_off):
            args.skip_off[i] = off
        args.n_skip_cols = n_skip_cols
        args.gate_off, args.gate_ld = layout["gate_off"], layout["gate_ld"]
        args.skips = out[2].data_ptr()
    elif mode == "events":
        row_counts, fallbacks = out[2], out[3]
        thr = dense_thresholds(widths[:-1], block_b, event_crossover)
        for i in range(n_layers):
            args.row_off[i] = layout["row_off"][i]
            args.dense_thr[i] = thr[i]
            args.row_counts[i] = row_counts[i].data_ptr()
        args.fb_off = layout["fb_off"]
        args.fallbacks = fallbacks.data_ptr()
        args.tc, args.chunk_ld = layout["tc"], layout["chunk_ld"]
        args.chunk_off[0], args.chunk_off[1] = layout["chunk_off"]
        args.ttot_off = layout["ttot_off"]

    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_snn_net_launch(ctypes.byref(args), MODE_CODES[mode],
                                       plan["grid"], layout["bytes"], stream)
    name = KERNEL_NAMES[mode]
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.fused_snn_net_error_string(err).decode()})")
    kernels.LAUNCH_COUNTS[name] += 1
    return out


_OP_SCHEMA = ("(Tensor spikes, Tensor[] ws, Tensor[] v_init, int[] thresholds, "
              "int[] leaks, str neuron, str clamp_mode, bool readout, "
              "bool emit_rasters, int block_b, int gate_granularity, "
              "float event_crossover) -> ")
_OP_RETURNS = {"dense": "(Tensor[], Tensor[])",
               "gated": "(Tensor[], Tensor[], Tensor)",
               "events": "(Tensor[], Tensor[], Tensor[], Tensor)"}


def _register(mode: str):
    """The custom operator ``repro_torch::<kernel name>`` of one mode: its
    CUDA implementation launches (`_launch`); its fake implementation, the
    one a trace runs, checks `launch_plan` and returns outputs of the
    launch's shapes. The kernel writes only its outputs (V comes back in
    fresh tensors; a caller that keeps V in place copies it), so the
    operator mutates none of its arguments."""

    def launch(spikes, ws, v_init, thresholds, leaks, neuron, clamp_mode,
               readout, emit_rasters, block_b, gate_granularity,
               event_crossover):
        return _launch(mode, spikes, ws, v_init, thresholds, leaks, neuron,
                       clamp_mode, readout, emit_rasters, block_b,
                       gate_granularity, event_crossover)

    def fake(spikes, ws, v_init, thresholds, leaks, neuron, clamp_mode,
             readout, emit_rasters, block_b, gate_granularity,
             event_crossover):
        return _op_outputs(mode, spikes, ws, readout, emit_rasters, block_b,
                           gate_granularity, neuron, clamp_mode)[1]

    op = torch.library.custom_op(
        f"repro_torch::{KERNEL_NAMES[mode]}", launch, mutates_args=(),
        device_types="cuda", schema=_OP_SCHEMA + _OP_RETURNS[mode])
    op.register_fake(fake)
    return op


#: one custom operator per kernel mode, named as its launch count
OPS = {mode: _register(mode) for mode in MODE_CODES}
