"""Compiled network-level SNN programs and their execution backends, in
PyTorch.

An `SNNProgram` comes in two domains. The float (QAT training) domain keeps
the trainable parameterization: softplus'd thresholds and leaks computed on
the parameter tensors, fake-quantized weights, surrogate-gradient spikes;
its backend, ``float``, is differentiable end to end. The int domain is the
deployed stack: the off-macro f32 spike
encoder (an identity-weight input layer, or the first conv of a conv
program), the on-macro convs (int8 HWIO kernels, lowered through im2col,
`core/mapping.py`), the spiking FC layers (int8 weights, 11-bit V) and the
accumulate-only int32 readout. Five backends execute it and are tested to
agree bit for bit with each other and with the JAX package's backends:

  int_ref     -- word-level ISA semantics in plain torch ops
                 (`kernels.fused_snn_net.ops.fused_snn_net_ref`), on any
                 device; ``use_sparse`` adds the gate counters, with the
                 whole batch as one tile;
  cuda        -- the fused-network CUDA kernel: the whole fc stack over all
                 timesteps in one launch, V and inter-layer spikes kept in
                 shared memory (`kernels.fused_snn_net.ops.fused_snn_net`;
                 on CPU tensors that wrapper runs the plain version);
  cuda_sparse -- the row-block gated kernel: a silent block of 128/G fan-in
                 rows issues no product (aux: skip counts per tile);
  ref_events  -- the host spike-list executor (`kernels.fused_snn_net.
                 events`): work proportional to events, the per-row
                 accounting contract (aux: row events);
  cuda_events -- the event-list kernel: each lane's active rows compacted
                 on the card and their weight rows gathered, with a dense
                 fallback above ``event_crossover`` (aux: row events equal
                 to ``ref_events``', plus fallback counts).

  bitmacro    -- the bit-level silicon oracle (`core.macro.BitMacro` banks,
                 on the host in numpy by nature; wrap programs only):
                 aux["macro_counts"] is the cycle tally it executed.

  float       -- the float domain's temporal executor (`run_float`, a
                 Python loop over timesteps through `_float_step`); on an
                 int program it renders the integer program in f32, exactly
                 (every value is an integer below 2^24): the bridge from
                 training to deployment.

Each on-macro conv layer is one call of the same kernels on its
(T, B*P, k*k*C) patch raster (``readout=False``), so every backend serves
conv programs. The same five kernel and plain backends stream FC and conv
programs: `stream_step` advances every lane one tick and `stream_megastep`
K ticks with one dispatch per on-macro conv and one for the fc stack,
carrying every layer's V as a `StreamState` (a conv's V map enters its
call flattened to (B*P, C), in `mapping.im2col_raster`'s frame order); the
float backend streams too, one eager `_float_step` a tick.

With ``mesh=`` (an `launch.mesh.SNNMesh`, int backends only) every int
backend, `stream_step`, `stream_megastep` and so the serving engine run on
`torch.distributed`: lanes over the data ranks, the macro's row-tiled
fan-in over the model ranks (`kernels.fused_snn_net.ops.
fused_snn_net_mesh`), bit for bit the single-device run.

Instruction counting is a program-level pass over the spike rasters
(`count_network_instructions`, `SparsityReport.instruction_counts`), so
every backend reports the same energy-model inputs by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.impulse_snn import SNNModelConfig
from repro_torch.core import isa, mapping
from repro_torch.core.isa import int_matmul
from repro_torch.core.neuron import NeuronState, neuron_step
from repro_torch.core.quant import (CLAMP_MODES, clamp_v, fake_quant_w,
                                    quantize_neuron_const, quantize_w,
                                    spike_compare)
from repro_torch.kernels.fused_snn_net.events import (EventStats,
                                                      fused_snn_net_events)
from repro_torch.kernels.fused_snn_net.kernel import GATE_GRANULARITIES, LANE
from repro_torch.kernels.fused_snn_net.ops import (
    DeviceEventCounts, LaneSplit, fused_snn_net, fused_snn_net_device_events,
    fused_snn_net_mesh_local, fused_snn_net_ref, gather_counters,
    gather_lanes, lane_shard, lane_split)

# ---------------------------------------------------------------------------
# Program representation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """One layer of a compiled program."""
    kind: str                     # encoder (off-macro f32, identity weight)
                                  # | conv (the first is the off-macro f32
                                  # spike encoder, later ones on-macro)
                                  # | fc (spiking, on-macro) | readout
    n_in: int                     # conv: the im2col fan-in k*k*c_in
    n_out: int
    w: Any = None                 # fc/readout: (n_in, n_out); conv: HWIO; on
                                  # the device. int domain: int8 on-macro, f32
                                  # encoder conv; float domain: f32
    threshold: Any = None         # encoder / encoder conv / float domain: f32
    leak: Any = None              # 0-d tensor; on-macro int layers: int
    scale: Any = None             # float <-> grid scale (python float)
    stride: int = 1               # conv only
    quantize: bool = True         # float (QAT) domain: fake-quant this w
    state_shape: tuple = ()       # per-example V shape ((H, W, C) for convs)

    @property
    def tiling(self) -> mapping.FCTiling:
        """This layer's macro-grid tiling (row and column tile counts of
        its n_in x n_out weight block, `mapping.fc_tiling`)."""
        return mapping.fc_tiling(self.n_in, self.n_out)


@dataclass(frozen=True)
class SNNProgram:
    """A compiled program: encoder (or conv encoder and convs), spiking FCs,
    readout, with its tensors on ``device``. ``domain`` is "int" (the
    deployed macro program) or "float" (QAT training, ``quantize`` turning
    fake-quant on)."""
    cfg: Optional[SNNModelConfig]
    neuron: str                   # if | lif | rmp
    timesteps: int                # presentation steps per input frame
    layers: tuple                 # tuple[LayerSpec, ...]
    clamp_mode: str = "saturate"  # V_MEM policy (see quant.clamp_v)
    device: torch.device = torch.device("cpu")
    domain: str = "int"           # "int" (deployed) | "float" (QAT training)
    quantize: bool = True         # float domain: QAT fake-quant on

    @property
    def fc_stack(self) -> tuple:
        """The FC part of the on-macro stack: spiking FCs + readout."""
        return tuple(ly for ly in self.layers if ly.kind in ("fc", "readout"))

    @property
    def int_conv_stack(self) -> tuple:
        """On-macro conv layers (quantized, scale set). The first conv of a
        stack is the off-macro encoder and never appears here."""
        return tuple(ly for ly in self.layers
                     if ly.kind == "conv" and ly.scale is not None)

    @property
    def macro_stack(self) -> tuple:
        """Everything that executes on macros: on-macro convs, spiking FCs,
        readout; the layers instruction counting iterates over."""
        return self.int_conv_stack + self.fc_stack

    @property
    def in_shape(self) -> tuple:
        """Per-example shape of one input frame: ``cfg.in_shape`` (H, W, C)
        for a conv program, the encoder's width for an FC program. Raises
        `ValueError` for a conv program built without its config."""
        if self.layers[0].kind != "conv":
            return tuple(self.layers[0].state_shape)
        if self.cfg is None:
            raise ValueError("a conv program's input shape comes from its "
                             "config; pass cfg= to program_from_arrays")
        return tuple(self.cfg.in_shape)

    @property
    def neuron_layers(self) -> tuple:
        """Layers with membrane dynamics that emit spikes."""
        return tuple(ly for ly in self.layers if ly.kind != "readout")

    def logits(self, v_out: torch.Tensor) -> torch.Tensor:
        """Readout V ``v_out`` (..., n_out) -> f32 logits of the same shape
        (an int program undoes the last layer's weight scale; a float
        program's V is its logits)."""
        if self.domain != "int":
            return v_out
        return v_out.to(torch.float32) * self.layers[-1].scale

    # -- streaming execution, the module functions as methods (JAX's API)
    def init_state(self, batch: int, backend: str = "float") -> StreamState:
        """Fresh per-layer membrane state for ``batch`` streams
        (`init_stream_state`)."""
        return init_stream_state(self, batch, backend)

    def step(self, state: StreamState, frame: torch.Tensor,
             backend: str = "float", **kw) -> tuple[StreamState, StreamOut]:
        """Advance every stream one tick on a (B, ...) current frame
        (`stream_step`)."""
        return stream_step(self, state, frame, backend, **kw)

    def megastep(self, state: StreamState, frames, backend: str = "float",
                 **kw) -> tuple[StreamState, MegastepOut]:
        """Advance every stream K ticks on a (K, B, ...) ``frames`` block
        in one ``backend`` dispatch (`stream_megastep`; ``kw`` passes
        through)."""
        return stream_megastep(self, state, frames, backend, **kw)


@dataclass
class NetResult:
    """What one backend run produces. ``rasters[i]`` is the *input* spike
    raster of macro-stack layer i (so rasters[0] is the encoder output):
    (T_total, B, n) int8 for FC layers, (T_total, B, H, W, C) spike maps
    feeding conv layers; ``v_final`` lists the final V of every layer,
    encoder first and readout last. ``aux`` holds the gate or event
    counters of the gated and event backends (`_attach_skips`,
    `_attach_event_stats`), as host numpy values."""
    v_out: torch.Tensor
    logits: torch.Tensor
    v_final: list
    rasters: Optional[list] = None
    aux: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus as ``logaddexp(x, 0)``, the JAX package's definition."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _host_f32(x) -> torch.Tensor:
    """A tensor or array as an f32 CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def _conv_state_shapes(cfg: SNNModelConfig, convs: list) -> list:
    """Per-example (H, W, C) output shape of every conv of ``cfg`` (SAME
    padding, the stride from ``cfg.conv_spec``, the kernel size and
    channels from the weights)."""
    hw, shapes = tuple(cfg.in_shape[:2]), []
    for c, (_, _, stride) in zip(convs, cfg.conv_spec):
        hw = mapping.conv_out_hw(hw, int(c["w"].shape[0]), stride)
        shapes.append((*hw, int(c["w"].shape[-1])))
    return shapes


def _param_f32(x, device: torch.device) -> torch.Tensor:
    """A parameter as an f32 tensor on ``device``, still attached to the
    autograd graph of the tensor it came from (numpy arrays are copied)."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def compile_network(cfg: SNNModelConfig, params: dict, *, domain: str = "float",
                    clamp_mode: str = "saturate", quantize: bool = True,
                    validate: bool = True, device=None) -> SNNProgram:
    """Lower (cfg, params) to an executable program of an FC or conv stack.

    ``domain="float"`` (the default, as in the JAX package) keeps the
    trainable parameterization and is differentiable: thresholds
    ``softplus(p) + 1e-3`` and leaks ``0.1 * softplus(p)`` are computed on
    the parameter tensors themselves (moved to ``device`` inside the graph),
    and the float weights are fake-quantized at run time when ``quantize``
    is on (every layer but the encoder conv). Run it on the ``float``
    backend.

    ``domain="int"`` is the deployed macro program: every on-macro layer
    quantizes onto its 6b/11b grid, weights through `quant.quantize_w`,
    thresholds and leaks through `quant.quantize_neuron_const` under
    ``clamp_mode``. The encoder, the identity input layer of an FC stack or
    the first conv of a conv stack, stays f32 (off-macro input layer, as in
    the paper). Later convs keep their HWIO int8 kernel and the im2col
    fan-in geometry (n_in = k*k*c_in, `mapping.conv_tiling`). Quantization
    runs on the CPU, detached from any graph.

    The program's tensors live on ``device`` (default: the CUDA device;
    raises without one). ``params``: ``{"layers": [{"w": (n_in, n_out)},
    ...], "threshold": (n_neuron_layers,), "leak": (n_neuron_layers,)}``
    plus, for a conv program, ``"convs": [{"w": (k, k, c_in, c_out)},
    ...]``, as `snn.init_fc_snn` / `snn.init_lenet_snn` make them (tensors
    or numpy arrays). Raises `ValueError` for an unknown domain or clamp
    mode, or parameters that do not match ``cfg``'s layers.

    ``validate`` (default on, as in the JAX package) runs
    `analysis.validate_program` on the compiled program before returning
    it: the range pass, the dense ``cuda`` kernel contract and the trace
    pass (every int backend's dispatch traced and checked) for an int
    program, the ``float`` contract otherwise. A refused program raises
    the named `AnalysisError` here, not mid-dispatch. The ``cuda``
    contract is stricter than the Pallas one (``smem_budget``,
    ``max_layers``): pass ``validate=False`` for a program meant for a
    host backend (``int_ref``, ``ref_events``) that the kernel cannot
    take."""
    if domain not in ("float", "int"):
        raise ValueError(f"unknown domain {domain!r}; have 'float', 'int'")
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp mode {clamp_mode!r}")
    convs = params.get("convs") or []
    if (len(convs) != len(cfg.conv_spec)
            or len(params["layers"]) != len(cfg.layer_sizes) - 1):
        raise ValueError(
            f"params hold {len(convs)} convs and {len(params['layers'])} FC "
            f"layers; the config has {len(cfg.conv_spec)} convs and "
            f"{len(cfg.layer_sizes) - 1} FC layers")
    device = resolve_device(device)
    int_dom = domain == "int"
    if int_dom:
        th = _softplus(_host_f32(params["threshold"])) + 1e-3
        lk = _softplus(_host_f32(params["leak"])) * 0.1
    else:
        th = _softplus(_param_f32(params["threshold"], device)) + 1e-3
        lk = _softplus(_param_f32(params["leak"], device)) * 0.1
    layers = []
    k = 0                                         # neuron-layer index
    if convs:
        c_in = cfg.in_shape[-1]
        for i, (c, shape) in enumerate(zip(convs,
                                           _conv_state_shapes(cfg, convs))):
            n_in = int(c["w"].shape[0] * c["w"].shape[1]) * c_in
            stride = cfg.conv_spec[i][2]
            if int_dom and i > 0:                 # on-macro conv
                wq, scale = quantize_w(_host_f32(c["w"]))
                layers.append(LayerSpec(
                    kind="conv", n_in=n_in, n_out=shape[-1], w=wq.to(device),
                    threshold=quantize_neuron_const(float(th[k]), scale,
                                                    clamp_mode),
                    leak=quantize_neuron_const(float(lk[k]), scale,
                                               clamp_mode),
                    scale=float(scale), stride=stride, quantize=False,
                    state_shape=shape))
            else:                                 # f32 encoder / float conv
                w = (_host_f32(c["w"]).to(device) if int_dom
                     else _param_f32(c["w"], device))
                layers.append(LayerSpec(
                    kind="conv", n_in=n_in, n_out=shape[-1], w=w,
                    threshold=th[k].to(device), leak=lk[k].to(device),
                    stride=stride, quantize=i > 0, state_shape=shape))
            c_in = shape[-1]
            k += 1
    else:
        d_in = cfg.layer_sizes[0]
        layers.append(LayerSpec(kind="encoder", n_in=d_in, n_out=d_in,
                                threshold=th[k].to(device),
                                leak=lk[k].to(device), state_shape=(d_in,)))
        k += 1
    sizes = cfg.layer_sizes
    fc_ws = params["layers"]
    for j, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        is_readout = j == len(fc_ws) - 1
        kind = "readout" if is_readout else "fc"
        if int_dom:
            wq, scale = quantize_w(_host_f32(fc_ws[j]["w"]))
            layers.append(LayerSpec(
                kind=kind, n_in=n_in, n_out=n_out, w=wq.to(device),
                threshold=None if is_readout else quantize_neuron_const(
                    float(th[k]), scale, clamp_mode),
                leak=None if is_readout else quantize_neuron_const(
                    float(lk[k]), scale, clamp_mode),
                scale=float(scale), state_shape=(n_out,)))
        else:
            layers.append(LayerSpec(
                kind=kind, n_in=n_in, n_out=n_out,
                w=_param_f32(fc_ws[j]["w"], device),
                threshold=None if is_readout else th[k],
                leak=None if is_readout else lk[k], state_shape=(n_out,)))
        if not is_readout:
            k += 1
    program = SNNProgram(cfg=cfg, neuron=cfg.spiking.neuron,
                         timesteps=cfg.timesteps, layers=tuple(layers),
                         clamp_mode=clamp_mode, device=device, domain=domain,
                         quantize=quantize)
    if validate:
        # lazy import: analysis consumes programs, pipeline produces them
        from repro_torch.analysis import validate_program
        validate_program(program)
    return program


def rate_coded_program(spiking_cfg, state_shape: tuple, device=None
                       ) -> SNNProgram:
    """Single-population float program: one encoder layer of per-example V
    shape ``state_shape`` integrating its input current, threshold and leak
    taken verbatim from ``spiking_cfg`` (no softplus re-parameterization).
    ``device`` defaults to the CUDA device (raises without one)."""
    layer = LayerSpec(kind="encoder", n_in=state_shape[-1],
                      n_out=state_shape[-1], threshold=spiking_cfg.threshold,
                      leak=spiking_cfg.leak, state_shape=tuple(state_shape))
    return SNNProgram(cfg=None, neuron=spiking_cfg.neuron,
                      timesteps=spiking_cfg.timesteps, layers=(layer,),
                      device=resolve_device(device), domain="float",
                      quantize=False)


def _check_kinds(kinds: list) -> None:
    """A program is encoder, fc..., readout, or conv (the encoder),
    conv..., fc..., readout. Raises `ValueError`."""
    n_conv = 0
    if kinds and kinds[0] == "conv":
        while n_conv < len(kinds) and kinds[n_conv] == "conv":
            n_conv += 1
        body = kinds[n_conv:]
    else:
        body = kinds[1:]
    if (len(kinds) < 2 or kinds[0] not in ("encoder", "conv")
            or not body or body[-1] != "readout"
            or any(k != "fc" for k in body[:-1])):
        raise ValueError(f"a program is encoder, fc..., readout or conv, "
                         f"conv..., fc..., readout; got layer kinds {kinds}")


def program_from_arrays(layers: list, *, neuron: str, timesteps: int,
                        clamp_mode: str = "saturate", device=None,
                        cfg: Optional[SNNModelConfig] = None) -> SNNProgram:
    """Build an integer `SNNProgram` from plain arrays, one dict per layer
    with ``kind``, ``n_in``, ``n_out``, ``w``, ``threshold``, ``leak`` and
    ``scale``: an FC program is "encoder" (``w`` None, f32 threshold and
    leak), "fc" layers (int8 (n_in, n_out) ``w``, int threshold and leak),
    then "readout" (threshold and leak None); a conv program starts with
    "conv" layers instead of the encoder, the first one the f32 encoder
    (f32 HWIO ``w``, f32 threshold and leak, ``scale`` None), later ones
    on-macro (int8 HWIO ``w``, int constants, ``scale``), each with its
    ``stride`` and per-example ``state_shape`` (H, W, C). Carries a
    compiled program across from another implementation with its constants
    unchanged. ``device`` defaults to the CUDA device (raises without
    one); ``cfg``, optional, is kept on the program (a conv program's
    input shape, `SNNProgram.in_shape`, comes from it)."""
    device = resolve_device(device)
    _check_kinds([d["kind"] for d in layers])
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"unknown clamp mode {clamp_mode!r}")
    specs = []
    for i, d in enumerate(layers):
        kind = d["kind"]
        if kind == "encoder" or (kind == "conv" and i == 0):    # off-macro
            th = torch.tensor(np.float32(d["threshold"]), device=device)
            lk = torch.tensor(np.float32(d["leak"]), device=device)
            w = (None if d["w"] is None else
                 torch.tensor(np.asarray(d["w"], np.float32), device=device))
        else:
            w = torch.tensor(np.asarray(d["w"], np.int8), device=device)
            spiking = kind != "readout"
            th = int(d["threshold"]) if spiking else None
            lk = int(d["leak"]) if spiking else None
        if kind == "conv":
            if (w is None or w.dim() != 4 or w.shape[0] != w.shape[1]
                    or w.shape[0] * w.shape[1] * w.shape[2] != d["n_in"]
                    or w.shape[3] != d["n_out"]):
                raise ValueError(f"conv kernel of shape "
                                 f"{None if w is None else tuple(w.shape)} "
                                 f"does not give (n_in, n_out) = "
                                 f"{(d['n_in'], d['n_out'])}")
            extra = dict(stride=int(d["stride"]), quantize=False,
                         state_shape=tuple(int(x) for x in d["state_shape"]))
        else:
            if w is not None and tuple(w.shape) != (d["n_in"], d["n_out"]):
                raise ValueError(f"{kind} weight shape {tuple(w.shape)} != "
                                 f"(n_in, n_out) = "
                                 f"{(d['n_in'], d['n_out'])}")
            extra = dict(state_shape=(int(d["n_out"]),))
        specs.append(LayerSpec(
            kind=kind, n_in=int(d["n_in"]), n_out=int(d["n_out"]), w=w,
            threshold=th, leak=lk,
            scale=None if d.get("scale") is None else float(d["scale"]),
            **extra))
    return SNNProgram(cfg=cfg, neuron=neuron,
                      timesteps=timesteps, layers=tuple(specs),
                      clamp_mode=clamp_mode, device=device)


# ---------------------------------------------------------------------------
# Input presentation
# ---------------------------------------------------------------------------

def present_words(x_words: torch.Tensor, timesteps: int) -> torch.Tensor:
    """``x_words`` (B, n_words, d) -> (n_words * timesteps, B, d): each
    word held ``timesteps`` steps (membrane state persists across words)."""
    return torch.repeat_interleave(x_words, timesteps, dim=1).movedim(1, 0)


def present_static(x: torch.Tensor, timesteps: int) -> torch.Tensor:
    """``x`` (B, ...) -> (timesteps, B, ...): direct encoding, the same
    frame presented every step (a broadcast view)."""
    return x[None].expand(timesteps, *x.shape)


# ---------------------------------------------------------------------------
# The off-macro encoder and the fc stack
# ---------------------------------------------------------------------------

def conv2d_f32(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME-padded 2-D convolution of NHWC f32 ``x`` with the HWIO f32
    kernel ``w`` at ``stride``, rounded as XLA:CPU rounds the JAX package's
    conv: each output sums its k*k*C_in terms in (kh, kw, c) order, from 0,
    with one fused multiply-add per term. The FMA is emulated exactly: the
    product of two f32 values is exact in float64, and the float64 sum is
    rounded to f32 after every term. Plain tensor code on every device:
    `torch.nn.functional.conv2d` sums in another order (and on the card in
    TF32), which flips encoder spikes, and one flipped spike changes
    everything after it."""
    k = w.shape[0]
    patches = mapping.im2col(x, k, stride).to(torch.float64)
    wp = mapping.pack_conv_weights(w).to(torch.float64)
    acc = torch.zeros((*patches.shape[:-1], wp.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r in range(wp.shape[0]):
        acc = (acc.to(torch.float64)
               + patches[..., r:r + 1] * wp[r]).to(torch.float32)
    return acc


def encoder_step(program: SNNProgram, v_enc: torch.Tensor,
                 frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One tick of the off-macro f32 encoder layer: carried membrane V plus
    a (B, ...) current frame -> (new V, (B, ...) int8 spikes). The identity
    encoder integrates the frame itself, the conv encoder its `conv2d_f32`.
    `encode` loops exactly this function, so streaming reproduces the batch
    raster."""
    enc = program.layers[0]
    current = (conv2d_f32(frame, enc.w, enc.stride) if enc.kind == "conv"
               else frame)
    st, s = neuron_step(NeuronState(v_enc), current, neuron=program.neuron,
                        threshold=enc.threshold, leak=enc.leak)
    return st.v, s.to(torch.int8)


def encode(program: SNNProgram, xs: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the encoder alone on (T_total, B, ...) f32 currents ->
    ((T_total, B, *state_shape) int8 spikes, final (B, *state_shape) f32
    encoder V); for a conv program the spikes are (H, W, C) maps."""
    enc = program.layers[0]
    shape = ((xs.shape[1], *enc.state_shape) if enc.kind == "conv"
             else tuple(xs.shape[1:]))
    v = torch.zeros(shape, dtype=torch.float32, device=xs.device)
    spikes = torch.empty((xs.shape[0], *shape), dtype=torch.int8,
                         device=xs.device)
    for t in range(xs.shape[0]):
        v, spikes[t] = encoder_step(program, v, xs[t])
    return spikes, v


def _host_events(spikes: torch.Tensor, ws: list, *, v_init=None, **kw):
    """`events.fused_snn_net_events` on device tensors: the inputs come off
    the device explicitly and the rasters and V go back onto it."""
    dev = spikes.device
    rasters, vs, stats = fused_snn_net_events(
        _host(spikes), [_host(w) for w in ws],
        v_init=None if v_init is None else [_host(v) for v in v_init], **kw)
    return ([torch.from_numpy(r).to(dev) for r in rasters],
            [torch.from_numpy(v).to(dev) for v in vs], stats)


def _host_events_sharded(spikes: torch.Tensor, ws: list, *,
                         split: LaneSplit, v_init=None, **kw) -> tuple:
    """``ref_events`` under a mesh. The host spike-list executor has no
    device placement, so the lane split happens on the host: each data
    rank runs the executor on its own contiguous lane slice (``spikes`` and
    ``v_init`` hold the rank's lanes, the first ``split.real`` of them
    real), and the rasters and V, padded back to the rank's lanes, are
    reassembled in lane order by the caller's all-gather. The per-slice
    `events.EventStats` merge exactly: row events and frames add (lanes
    never interact). The model axis is a no-op for a host executor: row
    tiles are a device concept. (The JAX package runs the slices one after
    another in one process; here each rank runs its own.) Returns
    (rasters, v_finals, counters) with the counters as
    ``{"row_events": per layer (1, n_in) int64, "dense_fallbacks": (1,
    0)}`` on the device, for `ops.gather_counters`."""
    real, lanes = split.real, split.lanes
    rasters, vs, stats = _host_events(
        spikes[:, :real], ws,
        v_init=None if v_init is None else [v[:real] for v in v_init], **kw)
    pad = lanes - real
    if pad:
        rasters = [torch.cat([r, r.new_zeros((r.shape[0], pad,
                                              *r.shape[2:]))], dim=1)
                   for r in rasters]
        vs = [torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]) for v in vs]
    dev = spikes.device
    counters = {"row_events": [torch.from_numpy(np.asarray(r, np.int64))
                               .to(dev)[None] for r in stats.row_events],
                "dense_fallbacks": torch.zeros((1, 0), dtype=torch.int32,
                                               device=dev)}
    return rasters, vs, counters


def _run_layers(program: SNNProgram, spikes: torch.Tensor, ws: list,
                thresholds: tuple, leaks: tuple, *, readout: bool,
                use_kernel: bool, emit_rasters: bool,
                v_init: Optional[list] = None, use_sparse: bool = False,
                gate_granularity: int = 1, use_events: bool = False,
                event_crossover: float = 1.0, block_b: int = 8,
                fold_events: bool = True, mesh=None,
                split: Optional[LaneSplit] = None) -> tuple:
    """One fused-stack dispatch of weights ``ws`` on a (T, B, d) raster.
    ``use_events`` runs the event-list kernel (``use_kernel``) or the host
    executor, and returns an `events.EventStats` (the kernel's
    `ops.DeviceEventCounts`, still on the device, with ``fold_events``
    false); otherwise the kernel
    wrapper (``use_kernel``) or its plain version, gated with
    ``use_sparse``. The plain version's tile is the whole batch (the JAX
    reference's layout), the kernel's ``block_b`` lanes. Returns
    (per-spiking-layer rasters, per-layer final V, counters).

    With ``mesh``, ``spikes`` and ``v_init`` hold this rank's lanes as
    ``split`` places them, and so do the rasters and V returned; the
    counters come back global (every rank's blocks stacked in lane order
    over the data group; the event counters folded over all lanes)."""
    kw = dict(thresholds=thresholds, leaks=leaks, neuron=program.neuron,
              clamp_mode=program.clamp_mode, emit_rasters=emit_rasters,
              readout=readout, v_init=v_init)
    if mesh is not None:
        return _run_layers_mesh(spikes, ws, kw, mesh=mesh, split=split,
                                use_kernel=use_kernel, use_sparse=use_sparse,
                                gate_granularity=gate_granularity,
                                use_events=use_events,
                                event_crossover=event_crossover,
                                block_b=block_b, fold_events=fold_events)
    if use_events and use_kernel:
        return fused_snn_net_device_events(
            spikes, ws, block_b=block_b, event_crossover=event_crossover,
            fold=fold_events, **kw)
    if use_events:
        return _host_events(spikes, ws, **kw)
    if use_kernel:
        return fused_snn_net(spikes, ws, use_sparse=use_sparse,
                             gate_granularity=gate_granularity,
                             block_b=block_b, **kw)
    th, lk = kw.pop("thresholds"), kw.pop("leaks")
    return fused_snn_net_ref(spikes, ws, th, lk, use_sparse=use_sparse,
                             gate_granularity=gate_granularity,
                             block_b=max(int(spikes.shape[1]), 1), **kw)


def _run_layers_mesh(spikes: torch.Tensor, ws: list, kw: dict, *, mesh,
                     split: LaneSplit, use_kernel: bool, use_sparse: bool,
                     gate_granularity: int, use_events: bool,
                     event_crossover: float, block_b: int,
                     fold_events: bool) -> tuple:
    """`_run_layers` on a mesh (see there): the host executor's lane split
    (`_host_events_sharded`) or `ops.fused_snn_net_mesh_local`, then the
    counters gathered over the data group."""
    if use_events and not use_kernel:
        rasters, vs, counters = _host_events_sharded(spikes, ws, split=split,
                                                     **kw)
    else:
        th, lk = kw.pop("thresholds"), kw.pop("leaks")
        rasters, vs, counters = fused_snn_net_mesh_local(
            spikes, ws, mesh=mesh, thresholds=th, leaks=lk,
            block_b=block_b, use_kernel=use_kernel, use_sparse=use_sparse,
            gate_granularity=gate_granularity, use_events=use_events,
            event_crossover=event_crossover, lanes=split.real, **kw)
    counters = gather_counters(counters, mesh)
    if use_events:
        counts = DeviceEventCounts(
            row_events=counters["row_events"],
            dense_fallbacks=counters["dense_fallbacks"],
            frames=int(spikes.shape[0]) * split.total)
        counters = (counts.fold() if fold_events or not use_kernel
                    else counts)
    return rasters, vs, counters


def _run_fc_stack(program: SNNProgram, spikes: torch.Tensor, **flags
                  ) -> tuple:
    """The fc stack (spiking FCs and the readout) on a (T, B, d) raster;
    ``flags``: the options of `_run_layers`."""
    stack = program.fc_stack
    return _run_layers(program, spikes, [spec.w for spec in stack],
                       tuple(spec.threshold for spec in stack[:-1]),
                       tuple(spec.leak for spec in stack[:-1]),
                       readout=True, **flags)


def _conv_front_end(program: SNNProgram, spikes_enc: torch.Tensor, *,
                    v_init: Optional[list] = None, **flags) -> tuple:
    """The on-macro conv layers on the encoder's spike maps. Each conv
    lowers onto the macro grid through im2col: its (T, B, H, W, C) input
    maps become a (T, B*P, k*k*C) patch raster, one frame per (example,
    output position), run by the same fused-stack dispatch as the fc stack
    (one layer, ``readout=False``, rasters on), so every backend serves
    conv programs. ``v_init`` (streaming) holds each conv's carried
    (B, H_out, W_out, C_out) V map, which enters the call flattened to
    (B*P, C_out): frame b*P + h*W_out + w, the order `mapping.
    im2col_raster` gives the patch raster. ``flags``: the options of
    `_run_layers`. Returns (maps, v_convs, conv_skips): per layer the
    output spike maps
    (T, B, H_out, W_out, C_out) int8, the final V maps and the counters
    (None when dense, `events.EventStats` on the event paths)."""
    maps, v_convs, conv_skips = [], [], []
    cur = spikes_enc
    for ci, spec in enumerate(program.int_conv_stack):
        t_total, batch = cur.shape[:2]
        k = spec.w.shape[0]
        patches = mapping.im2col_raster(cur, k, spec.stride)
        out_hw = mapping.conv_out_hw(tuple(cur.shape[2:4]), k, spec.stride)
        vi = (None if v_init is None else
              [v_init[ci].reshape(-1, spec.n_out)])
        call = dict(flags)
        if call.get("split") is not None:    # P patch frames an example
            call["split"] = flags["split"].scaled(out_hw[0] * out_hw[1])
        rasters, v, skips = _run_layers(
            program, patches, [mapping.pack_conv_weights(spec.w)],
            (spec.threshold,), (spec.leak,), readout=False,
            emit_rasters=True, v_init=vi, **call)
        cur = rasters[0].reshape(t_total, batch, *out_hw, spec.n_out)
        maps.append(cur)
        v_convs.append(v[0].reshape(batch, *out_hw, spec.n_out))
        conv_skips.append(skips)
    return maps, v_convs, conv_skips


def run_stack_from_raster(program: SNNProgram, spikes_enc: torch.Tensor, *,
                          use_kernel: bool = False, use_sparse: bool = False,
                          block_b: int = 8, gate_granularity: int = 1
                          ) -> tuple:
    """Run only the program's fc stack on a supplied (T, B, d) int8 encoder
    raster ``spikes_enc``, through the kernel wrapper (``use_kernel``) or
    its plain version, gated with ``use_sparse`` at ``gate_granularity``.
    Returns (rasters, v_stack, skips) with ``rasters[0]`` the input raster
    itself, as `sparsity_report` takes. A program with on-macro convs runs
    through `run_network` instead (raises `ValueError`)."""
    if program.int_conv_stack:
        raise ValueError("run_stack_from_raster runs the fc stack only; this "
                         "program has on-macro conv layers: run it through "
                         "run_network")
    rasters, v_stack, skips = _run_fc_stack(
        program, spikes_enc, use_kernel=use_kernel, use_sparse=use_sparse,
        gate_granularity=gate_granularity, block_b=block_b,
        emit_rasters=True)
    return [spikes_enc] + list(rasters), list(v_stack), skips


def _on_macro(program: SNNProgram, spikes_enc: torch.Tensor,
              emit_rasters: bool, flags: dict,
              state: Optional[StreamState] = None
              ) -> tuple:
    """Every on-macro call on a (T, B, ...) encoder raster: the conv front
    end, then the fc stack on the last map, flattened (its rasters per
    ``emit_rasters``); with a streaming ``state``, each call resumes from
    its carried V. ``flags``: the options of `_run_layers`. Returns (conv
    maps, conv V, conv counters, the fc stack's input raster, fc rasters,
    fc V, fc counters)."""
    n_convs = len(program.int_conv_stack)
    conv_maps, v_convs, conv_skips = _conv_front_end(
        program, spikes_enc,
        v_init=None if state is None else list(state.vs[1:1 + n_convs]),
        **flags)
    last = conv_maps[-1] if conv_maps else spikes_enc
    flat = last.reshape(*last.shape[:2], -1) if last.dim() > 3 else last
    rasters_fc, v_stack, skips = _run_fc_stack(
        program, flat, emit_rasters=emit_rasters,
        v_init=None if state is None else list(state.vs[1 + n_convs:]),
        **flags)
    return (conv_maps, v_convs, conv_skips, flat, rasters_fc, v_stack,
            skips)


def _run_macro_stack(program: SNNProgram, xs: torch.Tensor, *,
                     use_kernel: bool, mesh=None, **flags) -> NetResult:
    """Shared executor of every backend: the f32 encoder pass, the on-macro
    conv front end (when there is one), then the fc stack (``flags``: the
    mode options of `_run_layers`), with the gate or event counters
    attached to ``aux``; a gated run's conv counters go to
    ``aux["conv_skip_counts"]``, one entry per conv layer.

    With ``mesh``, each rank takes its lanes of the global ``xs`` and runs
    the encoder (per lane, so bit-exact on any split) and every on-macro
    call on them; the rasters and V come back global through an
    all-gather over the data group."""
    flags = dict(use_kernel=use_kernel, **flags)
    if mesh is not None:
        split = lane_split(xs.shape[1], mesh)
        xs = lane_shard(xs, 1, split)
        flags.update(mesh=mesh, split=split)
    spikes_enc, v_enc = encode(program, xs)
    conv_maps, v_convs, conv_skips, _, rasters_fc, v_stack, skips = \
        _on_macro(program, spikes_enc, True, flags)
    rasters = [spikes_enc] + conv_maps + list(rasters_fc)
    v_final = [v_enc] + v_convs + list(v_stack)
    if mesh is not None:
        rasters = [gather_lanes(r, 1, split, mesh) for r in rasters]
        v_final = [gather_lanes(v, 0, split, mesh) for v in v_final]
    v_out = v_final[-1]
    # rasters[i] is the input raster of macro-stack layer i: spike maps for
    # the convs (the last conv's map, flattened, is the fc stack's input)
    res = NetResult(v_out=v_out, logits=program.logits(v_out),
                    v_final=v_final, rasters=rasters)
    if flags.get("use_events"):
        return _attach_event_stats(res, conv_skips, skips)
    res = _attach_skips(res, skips, xs.shape[0],
                        flags.get("gate_granularity", 1))
    if flags.get("use_sparse") and conv_skips:
        res.aux["conv_skip_counts"] = [
            [_host(b) for b in s] if isinstance(s, list) else _host(s)
            for s in conv_skips]
    return res


def _site_count(s: np.ndarray) -> int:
    """Gate sites per timestep of one skip-count array: tiles x columns."""
    return s.shape[0] * s.shape[1]


def _attach_skips(res: NetResult, skips, timesteps: int,
                  granularity: int = 1) -> NetResult:
    """Put the gate counters on a result: the skip counts (host arrays) and
    the share of gate sites skipped (every site gates once per timestep).
    At granularity 1 a site is a (tile, layer) pair and the share is
    ``skipped_tile_fraction``; at finer granularities a (tile, layer,
    block) triple, the counts a per-layer list, and the share
    ``skipped_block_fraction``."""
    if skips is None:
        return res
    if granularity == 1:
        skips = _host(skips)
        res.aux["skip_counts"] = skips
        res.aux["skipped_tile_fraction"] = float(skips.sum()) / float(
            timesteps * _site_count(skips))
        return res
    skips = [_host(s) for s in skips]
    res.aux["skip_counts"] = skips
    sites = sum(_site_count(s) for s in skips)
    res.aux["skipped_block_fraction"] = float(
        sum(int(s.sum()) for s in skips)) / float(timesteps * sites)
    return res


def _attach_event_stats(res: NetResult, conv_stats: list, stats: EventStats
                        ) -> NetResult:
    """Put the `events.EventStats` of the conv layers and the fc stack on a
    result: per-row event counts, the frames each layer ran (a conv layer
    one per (timestep, example, output position)), silent-row counts, the
    share of (frame, row) sites that were silent, and (event kernel only)
    the per-layer dense fallback counts."""
    row_events = [r for st in conv_stats for r in st.row_events]
    row_events += list(stats.row_events)
    frames = [st.frames for st in conv_stats for _ in st.row_events]
    frames += [stats.frames] * len(stats.row_events)
    skipped = [f * len(r) - int(r.sum()) for f, r in zip(frames, row_events)]
    possible = sum(f * len(r) for f, r in zip(frames, row_events))
    res.aux["row_events"] = row_events
    res.aux["row_event_frames"] = frames
    res.aux["row_skip_counts"] = skipped
    res.aux["skipped_row_fraction"] = (sum(skipped) / possible
                                       if possible else 0.0)
    fallbacks = [f for st in conv_stats for f in st.dense_fallbacks]
    fallbacks += list(stats.dense_fallbacks)
    if fallbacks:
        res.aux["event_dense_fallbacks"] = fallbacks
    return res


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

BACKENDS: dict[str, Callable] = {}


def register_backend(name: str) -> Callable:
    """Decorator that registers an execution backend under ``name`` in
    `BACKENDS`, the `run_network` dispatch table."""
    def deco(fn: Callable) -> Callable:
        BACKENDS[name] = fn
        return fn
    return deco


def _w_float(program: SNNProgram, spec: LayerSpec) -> torch.Tensor:
    """The f32 weight a float-backend step multiplies by: an int program's
    int8 weight as f32, a QAT layer's fake-quantized weight, else the float
    weight itself."""
    if program.domain == "int":
        return spec.w.to(torch.float32)
    if program.quantize and spec.quantize:
        return fake_quant_w(spec.w)
    return spec.w


def _float_weights(program: SNNProgram) -> list:
    """`_w_float` of every layer (None for the identity encoder), computed
    once per run: the same values a per-step call gives, with one
    quantization in the graph instead of one per timestep."""
    return [None if spec.w is None else _w_float(program, spec)
            for spec in program.layers]


def _float_step(program: SNNProgram, vs: list, xt: torch.Tensor,
                ws: Optional[list] = None) -> tuple[list, list]:
    """One network timestep of the float backend on a (B, ...) current
    ``xt``, with the layers' weights ``ws`` (`_float_weights`; computed
    here when None). Returns (new per-layer V, per-neuron-layer f32
    spikes). QAT layers run `neuron.neuron_step` (surrogate spikes); an int
    program's on-macro layers run the f32 rendering of the word-level ISA
    (clamp, leak, SpikeCheck, soft or hard reset), exact because every
    value is an integer below 2^24. Convs go through `conv2d_f32`."""
    if ws is None:
        ws = _float_weights(program)
    neuron = program.neuron
    int_dom = program.domain == "int"
    mode = program.clamp_mode
    cur = xt
    vs_new, spikes = [], []
    for i, (spec, w) in enumerate(zip(program.layers, ws)):
        if spec.kind in ("fc", "readout") and cur.dim() > 2:
            cur = cur.reshape(cur.shape[0], -1)
        if spec.kind == "readout":
            vs_new.append(vs[i] + cur @ w)
            continue
        if spec.kind == "conv":
            current = conv2d_f32(cur, w, spec.stride)
        elif spec.kind == "fc":
            current = cur @ w
        else:                                     # encoder: identity weight
            current = cur
        if int_dom and spec.scale is not None:    # on-macro (fc or conv)
            th = float(spec.threshold)
            v = clamp_v(vs[i] + current, mode)
            if neuron == "lif":
                v = clamp_v(v - float(spec.leak), mode)
            s = spike_compare(v, th, mode).to(torch.float32)
            if neuron == "rmp":
                v = clamp_v(torch.where(s > 0, v - th, v), mode)
            else:
                v = torch.where(s > 0, 0.0, v)
        else:
            st, s = neuron_step(NeuronState(vs[i]), current, neuron=neuron,
                                threshold=spec.threshold, leak=spec.leak)
            v = st.v
        vs_new.append(v)
        spikes.append(s)
        cur = s
    return vs_new, spikes


def _init_vs(program: SNNProgram, batch: int) -> list:
    """All-zero f32 V of every layer for ``batch`` examples."""
    return [torch.zeros((batch, *spec.state_shape), dtype=torch.float32,
                        device=program.device) for spec in program.layers]


@register_backend("float")
def run_float(program: SNNProgram, xs: torch.Tensor, *,
              return_trace: bool = False, collect_rasters: bool = False,
              collect_sums: bool = False, static_input: bool = False
              ) -> NetResult:
    """Differentiable run over the whole presentation, a Python loop of
    `_float_step` over timesteps. ``aux["spike_rates"]`` is (T, n_neuron
    layers) mean spike rates; ``aux["v_trace"]`` the (T, B) readout V of
    output 0 with ``return_trace`` (zeros otherwise); ``collect_rasters``
    adds the per-neuron-layer (T, B, ...) f32 rasters, ``collect_sums``
    ``aux["spike_sums"]``, the per-layer spike counts over all steps.

    ``static_input``: ``xs`` is one (B, ...) frame presented
    ``program.timesteps`` times (direct encoding)."""
    xs = torch.as_tensor(xs, device=program.device)
    batch = xs.shape[0] if static_input else xs.shape[1]
    steps = program.timesteps if static_input else xs.shape[0]
    ws = _float_weights(program)
    vs = _init_vs(program, batch)
    sums = ([torch.zeros((batch, *spec.state_shape), dtype=torch.float32,
                         device=program.device)
             for spec in program.neuron_layers] if collect_sums else None)
    rates, trace, rasters = [], [], []
    for t in range(steps):
        vs, spikes = _float_step(program, vs, xs if static_input else xs[t],
                                 ws)
        rates.append(torch.stack([s.mean() for s in spikes]))
        if return_trace:
            trace.append(vs[-1][:, 0])
        if collect_sums:
            sums = [c + s for c, s in zip(sums, spikes)]
        if collect_rasters:
            rasters.append(spikes)
    aux = {"spike_rates": torch.stack(rates),
           "v_trace": (torch.stack(trace) if return_trace else
                       torch.zeros((steps, batch), device=program.device))}
    if collect_sums:
        aux["spike_sums"] = sums
    v_out = vs[-1]
    return NetResult(
        v_out=v_out, logits=program.logits(v_out), v_final=vs,
        rasters=([torch.stack([r[i] for r in rasters])
                  for i in range(len(rasters[0]))]
                 if collect_rasters else None),
        aux=aux)


@register_backend("int_ref")
def run_int_ref(program: SNNProgram, xs: torch.Tensor, *,
                use_sparse: bool = False, mesh=None) -> NetResult:
    """Word-level ISA semantics in plain torch ops, on any device.
    ``use_sparse`` adds the gate counters at granularity 1, the whole
    batch one tile. ``mesh`` runs the macro stack on a mesh, bit for bit
    the single-device run (`run_network`)."""
    return _run_macro_stack(program, xs, use_kernel=False,
                            use_sparse=use_sparse, mesh=mesh)


@register_backend("cuda")
def run_cuda(program: SNNProgram, xs: torch.Tensor, *, mesh=None
             ) -> NetResult:
    """``program`` on input currents ``xs`` through the fused-network CUDA
    kernel: one launch for the fc stack over all timesteps (and one per
    on-macro conv). On CPU tensors its wrapper runs the plain version.
    ``mesh``: each data rank launches the kernel on its lanes (model extent
    1), or the ranks run the row-partial ticks (`run_network`)."""
    return _run_macro_stack(program, xs, use_kernel=True, mesh=mesh)


@register_backend("cuda_sparse")
def run_cuda_sparse(program: SNNProgram, xs: torch.Tensor, *,
                    block_b: int = 8, gate_granularity: int = 1, mesh=None
                    ) -> NetResult:
    """The row-block gated kernel: per (timestep, layer, tile of
    ``block_b`` lanes, block of 128/G fan-in rows) the product runs only if
    the block holds a spike; the neuron update runs every timestep, so
    results equal every dense backend. aux: ``skip_counts`` ((tiles,
    n_layers) at G = 1, a per-layer list of (tiles, n_blocks) at G in
    {2, 4, 8}) and ``skipped_tile_fraction`` / ``skipped_block_fraction``;
    on a ``mesh`` of model extent 1 the data ranks' tiles in lane order,
    above it none (`run_network`)."""
    return _run_macro_stack(program, xs, use_kernel=True, use_sparse=True,
                            block_b=block_b,
                            gate_granularity=gate_granularity, mesh=mesh)


@register_backend("ref_events")
def run_ref_events(program: SNNProgram, xs: torch.Tensor, *, mesh=None
                   ) -> NetResult:
    """``program`` on input currents ``xs`` through the host spike-list
    executor: every (timestep, example) frame is compacted to its active
    rows and AccW2V gathers their weight rows, so
    the work is proportional to events. aux: ``row_events`` (per layer,
    per input row), ``row_event_frames``, ``row_skip_counts`` and
    ``skipped_row_fraction``. ``mesh``: each data rank runs the executor
    on its lanes and the counters add (`_host_events_sharded`)."""
    return _run_macro_stack(program, xs, use_kernel=False, use_events=True,
                            mesh=mesh)


@register_backend("cuda_events")
def run_cuda_events(program: SNNProgram, xs: torch.Tensor, *,
                    block_b: int = 8, event_crossover: float = 1.0,
                    mesh=None) -> NetResult:
    """The event-list kernel: each lane's active rows are compacted on the
    card and their weight rows gathered; a tile of ``block_b`` lanes whose
    event count is above ``event_crossover`` of its capacity takes the
    dense product (the same values either way; 1.0 never does). aux: as
    ``ref_events`` (the kernel's row counters equal its executor's) plus
    ``event_dense_fallbacks`` per layer (none on a ``mesh`` of model extent
    above 1, whose row-partial ticks have no fallback; `run_network`)."""
    return _run_macro_stack(program, xs, use_kernel=True, use_events=True,
                            block_b=block_b, event_crossover=event_crossover,
                            mesh=mesh)


def _bitmacro_layer(inp: np.ndarray, wq: np.ndarray, threshold: int,
                    leak: int, neuron: str) -> tuple:
    """One spiking layer on banks of bit-level macros: (T, F, n_in) bool
    input frames -> ((T, F, n_out) int8 spikes, (F, n_out) int32 final V,
    the executed `isa.InstrCount`).

    Frames (examples, or (example, output position) pairs of a conv) take
    one V_MEM neuron set each, 13 per macro grid; more frames claim more
    banks. The fan-in splits over ``row_tiles`` macros
    (`mapping.tile_weights`): row tile 0 holds V and the constants, the
    others accumulate the timestep's partial sums, which AccV2V (odd and
    even cycle per tile) reduces into tile 0 before its neuron update.
    Wrap arithmetic composes mod 2**11, so the split equals one word-level
    accumulate. The executed cycles equal `isa.count_layer_instructions`
    of the input raster."""
    from repro_torch.core.macro import BitMacro
    t_total, n_frames, _ = inp.shape
    n_out = wq.shape[1]
    tiling = mapping.fc_tiling(wq.shape[0], n_out)
    tiles = mapping.tile_weights(wq)
    n_banks = -(-n_frames // isa.N_NEURON_SETS)
    banks = [[[BitMacro.from_weights(tiles[r, c], threshold=threshold,
                                     leak=leak)
               for c in range(tiling.col_tiles)]
              for r in range(tiling.row_tiles)]
             for _ in range(n_banks)]
    out = np.zeros((t_total, n_frames, n_out), np.int8)
    for t in range(t_total):
        for f in range(n_frames):
            bank, set_idx = divmod(f, isa.N_NEURON_SETS)
            grid = banks[bank]
            for row in np.nonzero(inp[t, f])[0]:         # event-driven AccW2V
                r, macro_row = divmod(int(row), isa.MACRO_IN)
                for c in range(tiling.col_tiles):
                    grid[r][c].acc_w2v(set_idx, macro_row, cycle=0)
                    grid[r][c].acc_w2v(set_idx, macro_row, cycle=1)
            for r in range(1, tiling.row_tiles):         # AccV2V reduction
                for c in range(tiling.col_tiles):
                    partial = grid[r][c].transfer_v(set_idx)
                    for cycle in (0, 1):
                        grid[0][c].acc_v2v(set_idx, partial, cycle)
            spikes = np.concatenate(
                [grid[0][c].neuron_update(set_idx, neuron)
                 for c in range(tiling.col_tiles)])
            out[t, f] = spikes[:n_out].astype(np.int8)
    v = np.stack([
        mapping.untile_outputs(np.stack(
            [banks[f // isa.N_NEURON_SETS][0][c]
             .read_v(f % isa.N_NEURON_SETS)
             for c in range(tiling.col_tiles)]), n_out)
        for f in range(n_frames)])
    counts = sum((m.counts for bank in banks for row in bank for m in row),
                 isa.InstrCount())
    return out, v.astype(np.int32), counts


@register_backend("bitmacro")
def run_bitmacro(program: SNNProgram, xs: torch.Tensor) -> NetResult:
    """The program's on-macro stack on bit-level macros (the silicon
    oracle): row-tiled fan-in with AccV2V reduction, conv layers through
    im2col (one neuron set per (example, output position)), extra macro
    banks beyond 13 frames (`_bitmacro_layer`). The encoder runs on the
    program's device; the macros run on the host in numpy (their inputs
    are copied there, the results back onto the device). The readout
    accumulates word-level, off the bit array, as deployed.
    aux["macro_counts"]: the executed `isa.InstrCount` (the raster count
    without the readout's). Raises `ValueError` unless the program is in
    ``clamp_mode="wrap"``, the silicon's arithmetic."""
    if program.clamp_mode != "wrap":
        raise ValueError("bitmacro executes silicon wrap arithmetic; compile "
                         "the program with clamp_mode='wrap'")
    dev = program.device
    spikes_enc, v_enc = encode(program, xs)
    cur = _host(spikes_enc).astype(np.int8)
    t_total, batch = cur.shape[:2]
    stack = program.macro_stack
    rasters, v_stack = [spikes_enc], []
    total = isa.InstrCount()
    for spec in stack[:-1]:
        wq = _host(spec.w)
        if spec.kind == "conv":
            k = wq.shape[0]
            inp = _host(mapping.im2col_raster(torch.from_numpy(cur), k,
                                              spec.stride)).astype(bool)
            out_hw = mapping.conv_out_hw(cur.shape[2:4], k, spec.stride)
            wq = mapping.pack_conv_weights(wq)
        else:
            inp = cur.reshape(t_total, -1, spec.n_in).astype(bool)
        out, v, counts = _bitmacro_layer(inp, wq, int(spec.threshold),
                                         int(spec.leak), program.neuron)
        total += counts
        if spec.kind == "conv":
            cur = out.reshape(t_total, batch, *out_hw, spec.n_out)
            v = v.reshape(batch, *out_hw, spec.n_out)
        else:
            cur = out
        rasters.append(torch.from_numpy(cur).to(dev))
        v_stack.append(torch.from_numpy(v).to(dev))
    flat = cur.reshape(t_total, batch, -1).astype(np.int64)
    v_out = flat.sum(axis=0) @ _host(stack[-1].w).astype(np.int64)
    v_out = torch.from_numpy(v_out.astype(np.int32)).to(dev)
    res = NetResult(v_out=v_out, logits=program.logits(v_out),
                    v_final=[v_enc] + v_stack + [v_out], rasters=rasters)
    res.aux["macro_counts"] = total
    return res


def _no_mesh(backend: str) -> ValueError:
    return ValueError(
        f"backend {backend!r} has no mesh execution: float reductions are "
        "not bitwise order-exact across shards and bitmacro state lives in "
        "host BitMacro objects; use an int device backend (int_ref/cuda/"
        "cuda_sparse/ref_events/cuda_events)")


def run_network(program: SNNProgram, xs: torch.Tensor,
                backend: str = "int_ref", **kw) -> NetResult:
    """Execute ``program`` on per-timestep input currents ``xs``
    (T_total, B, d) f32 on the program's device, through ``backend``
    (``kw``: that backend's options); every layer's input raster comes
    back in `NetResult.rasters`. Only the ``float`` backend runs a float
    program (raises `ValueError` otherwise).

    ``mesh`` (int backends only): an `launch.mesh.SNNMesh` with "data"
    and/or "model" axes. Every rank passes the global ``xs`` and gets the
    global result: lanes split over the data ranks and come back by an
    all-gather; the row-tiled fan-in splits over the model ranks, whose
    unclamped int32 partial V one integer all-reduce adds before the one
    clamp. The rasters, every V, ``v_out``, the logits and the row-event
    counters equal the single-device run bit for bit; the gate counters
    are the data ranks' tiles in lane order (model extent 1; equal to the
    single-device ones when ``block_b`` divides the per-rank batch) and
    absent above model extent 1, where there is no dense fallback either.
    The float backend's f32 reductions are not order-exact and the
    bitmacro oracle is host-side state: both reject a mesh with
    `ValueError`."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; have {sorted(BACKENDS)}")
    if backend != "float" and program.domain != "int":
        raise ValueError(f"backend {backend!r} needs an int-domain program "
                         "(compile_network(..., domain='int'))")
    if backend in ("float", "bitmacro") and kw.pop("mesh", None) is not None:
        raise _no_mesh(backend)
    return BACKENDS[backend](program, xs, **kw)


# ---------------------------------------------------------------------------
# Streaming execution
#
# Membrane potential is persistent per-neuron state, so sequential inputs
# arrive frame by frame and V stays resident. `init_stream_state` /
# `stream_step` / `stream_megastep` run the same backends one tick or K
# ticks at a time, carrying every layer's V in a `StreamState`. All
# on-macro arithmetic is integer (exact) and the encoder runs the same
# per-tick f32 ops as `encode`, so streaming a raster reproduces
# `run_network` bit for bit. Lanes never interact.
# ---------------------------------------------------------------------------

STREAM_BACKENDS = ("float", "int_ref", "cuda", "cuda_sparse", "ref_events",
                   "cuda_events")


class StreamState(NamedTuple):
    """Carried membrane state: one V tensor per program layer (encoder
    first, readout last), each (B, *state_shape) with the lane on axis 0:
    f32 for the encoder ((B, H, W, C) for a conv encoder), int32 for the
    on-macro convs ((B, H_out, W_out, C)) and the fc stack; f32 for every
    layer on the ``float`` backend."""
    vs: tuple
    t: int = 0           # ticks executed (bookkeeping only)


@dataclass
class StreamOut:
    """What one `stream_step` tick produces. ``rasters[i]`` is macro-stack
    layer i's input raster of this tick, (B, n), or (B, H, W, C) spike maps
    feeding a conv (None without ``emit_rasters``). ``skips`` holds the fc
    stack's counters of the tick in the layout `run_network` puts in aux:
    the gate counts of the gated paths (summed over ticks they equal a
    batch run's), an `events.EventStats` on the event paths, else None;
    ``conv_skips`` one such entry per on-macro conv (None without
    convs)."""
    v_out: Any
    logits: Any
    rasters: Optional[list] = None
    skips: Any = None
    conv_skips: Any = None


@dataclass
class MegastepOut:
    """What one K-frame `stream_megastep` block produces. ``rasters[i]``
    keeps its K axis, (K, B, n). ``v_out_traj``/``logits_traj`` are the
    per-tick readout trajectory within the block, what a server needs to
    finalize a request that finishes mid-block with the values a
    tick-by-tick drain gives; ``frames_consumed`` is the per-lane count of
    real (unmasked) frames; ``skips`` and ``conv_skips`` the block's
    counters, as in `StreamOut`."""
    v_out: Any                    # (B, n_out) readout V after the block
    logits: Any                   # (B, n_out)
    v_out_traj: Any               # (K, B, n_out) per-tick readout V
    logits_traj: Any              # (K, B, n_out)
    frames_consumed: Any          # (B,) int32
    rasters: Optional[list] = None
    skips: Any = None
    conv_skips: Any = None


def _check_stream(program: SNNProgram, backend: str) -> None:
    """Raises `KeyError` for a backend with no streaming entry (bitmacro's
    state lives in host `BitMacro` objects, not in tensors), and
    `ValueError` for a float program on any backend but ``float``."""
    if backend not in STREAM_BACKENDS:
        raise KeyError(f"unknown streaming backend {backend!r}; have "
                       f"{STREAM_BACKENDS}")
    if backend != "float" and program.domain != "int":
        raise ValueError(f"backend {backend!r} needs an int-domain program "
                         "(compile_network(..., domain='int'))")


def _stream_flags(backend: str, use_sparse: bool, block_b: int,
                  gate_granularity: int, event_crossover: float) -> dict:
    """`_run_layers` options of a streaming ``backend`` and its kwargs:
    the kernel on the cuda* backends, the event list on the *events ones,
    gating on cuda_sparse (or wherever ``use_sparse`` asks for it)."""
    return dict(use_kernel=backend.startswith("cuda"),
                use_events=backend.endswith("events"),
                use_sparse=use_sparse or backend == "cuda_sparse",
                block_b=block_b, gate_granularity=gate_granularity,
                event_crossover=event_crossover)


def init_stream_state(program: SNNProgram, batch: int,
                      backend: str = "int_ref") -> StreamState:
    """Fresh (all-zero V) state for ``batch`` streams on the program's
    device."""
    _check_stream(program, backend)
    vs = tuple(torch.zeros((batch, *spec.state_shape),
                           dtype=(torch.float32 if i == 0 or backend == "float"
                                  else torch.int32),
                           device=program.device)
               for i, spec in enumerate(program.layers))
    return StreamState(vs=vs, t=0)


def _mesh_stream_in(state: StreamState, frames: torch.Tensor,
                    lane_dim: int, mesh) -> tuple:
    """The rank's view of a streaming call on ``mesh``: the `LaneSplit` of
    the global ``frames``' lanes (dimension ``lane_dim``), whether
    ``state`` is replicated (its leaves hold every lane: what
    `dist.sharding.snn_state_specs` places when the lanes do not divide
    the data extent) or the rank's shard, the rank's state and its frames.
    Raises `ValueError` for a state placed neither way."""
    split = lane_split(frames.shape[lane_dim], mesh)
    lanes = {int(v.shape[0]) for v in state.vs}
    replicated = split.n_data > 1 and lanes == {split.total}
    if not replicated and lanes != {split.lanes}:
        raise ValueError(
            f"a streaming state on {mesh} must hold this rank's "
            f"{split.lanes} lanes (its shard) or all {split.total} "
            f"(replicated), got leaves of {sorted(lanes)} lanes")
    vs = (tuple(lane_shard(v, 0, split) for v in state.vs) if replicated
          else state.vs)
    return (split, replicated, state._replace(vs=vs),
            lane_shard(frames, lane_dim, split))


def _mesh_state_out(vs: tuple, split: LaneSplit, replicated: bool, mesh
                    ) -> tuple:
    """The new state's leaves in the placement the call's state came in."""
    if not replicated:
        return tuple(vs)
    return tuple(gather_lanes(v, 0, split, mesh) for v in vs)


def stream_step(program: SNNProgram, state: StreamState, frame: torch.Tensor,
                backend: str = "int_ref", *, emit_rasters: bool = True,
                use_sparse: bool = False, block_b: int = 8,
                gate_granularity: int = 1, event_crossover: float = 1.0,
                mesh=None) -> tuple[StreamState, StreamOut]:
    """Advance every stream one tick on a (B, *in_shape) current ``frame``:
    (state, frame) -> (new state, StreamOut). Each on-macro conv and the
    fc stack resume from the carried V through the kernels' ``v_init``
    entry; the last conv's maps, flattened, are the fc stack's input. The
    backend options mirror `run_network`: ``use_sparse`` gates the int_ref tick,
    ``block_b`` sets the kernels' tile, ``gate_granularity`` the gated
    blocks and ``event_crossover`` the event kernel's dense fallback. On
    ``float`` the tick is one `_float_step` and ``rasters`` holds every
    neuron layer's f32 spikes.

    ``mesh`` (an `launch.mesh.SNNMesh`; not on ``float``, which raises
    `ValueError`) runs the tick's on-macro calls on the mesh, bit for bit
    the single-device tick (`run_network`). ``frame`` is global; ``state``
    is the rank's shard as `dist.sharding.snn_state_specs` places it (the
    rank's lanes when they divide the data extent, every lane otherwise),
    and the new state comes back placed the same way; the `StreamOut`
    (V, logits, rasters, counters) is global."""
    _check_stream(program, backend)
    if backend == "float" and mesh is not None:
        raise _no_mesh(backend)
    if backend == "float":
        vs, spikes = _float_step(program, list(state.vs), frame)
        v_out = vs[-1]
        return (StreamState(vs=tuple(vs), t=state.t + 1),
                StreamOut(v_out=v_out, logits=program.logits(v_out),
                          rasters=list(spikes) if emit_rasters else None))
    flags = _stream_flags(backend, use_sparse, block_b, gate_granularity,
                          event_crossover)
    if mesh is not None:
        split, replicated, state, frame = _mesh_stream_in(state, frame, 0,
                                                          mesh)
        flags.update(mesh=mesh, split=split)
    v_enc, spikes_enc = encoder_step(program, state.vs[0], frame)
    conv_maps, v_convs, conv_skips, _, rasters_fc, v_stack, skips = \
        _on_macro(program, spikes_enc[None], emit_rasters, flags, state)
    rasters = None
    if emit_rasters:
        rasters = ([spikes_enc] + [m[0] for m in conv_maps]
                   + [r[0] for r in rasters_fc])
    new_vs = (v_enc,) + tuple(v_convs) + tuple(v_stack)
    v_out = v_stack[-1]
    if mesh is not None:
        if rasters is not None:
            rasters = [gather_lanes(r, 0, split, mesh) for r in rasters]
        v_out = gather_lanes(v_out, 0, split, mesh)
        new_vs = _mesh_state_out(new_vs, split, replicated, mesh)
    return (StreamState(vs=new_vs, t=state.t + 1),
            StreamOut(v_out=v_out, logits=program.logits(v_out),
                      rasters=rasters, skips=skips,
                      conv_skips=conv_skips or None))


def stream_megastep(program: SNNProgram, state: StreamState,
                    frames, backend: str = "int_ref", *, active=None,
                    emit_rasters: bool = True, use_sparse: bool = False,
                    block_b: int = 8, gate_granularity: int = 1,
                    event_crossover: float = 1.0, fold_events: bool = True,
                    mesh=None) -> tuple[StreamState, MegastepOut]:
    """Advance every stream K ticks with one dispatch per on-macro conv and
    one for the fc stack: (state, (K, B, *in_shape) current block) -> (new
    state, MegastepOut). Integer arithmetic is exact, so one K-frame call
    equals K chained one-frame calls bit for bit.

    ``active`` (optional (B,) ints) is the per-lane active-tick count:
    frames at tick t >= active[lane] are zeroed before integration, so a
    short or evicted stream integrates zero current, and
    ``frames_consumed`` reports min(active, K). The lane still advances K
    ticks; a server that retires a lane mid-block re-seeds it.

    The readout accumulator is unclamped int32, so the per-tick readout
    trajectory is recovered exactly as ``v_init + cumsum(raster @ W_ro)``
    (int32 addition is associative). This makes the fc stack emit its
    rasters even when ``emit_rasters=False``. The product goes through
    `isa.int_matmul`, since CUDA has no int32 matmul. The backend options
    are `stream_step`'s. With ``fold_events`` false the ``cuda_events``
    counters stay on the device as `ops.DeviceEventCounts` (their
    ``fold()`` gives the `EventStats`), so the block runs without a copy
    to the host, as a CUDA graph must. On ``float`` the block is K eager
    `_float_step` ticks, equal to K `stream_step` calls bit for bit, and
    ``rasters`` holds every neuron layer's (K, B, ...) f32 spikes.

    ``mesh`` runs the block's on-macro calls on the mesh (not on
    ``float``: `ValueError`), bit for bit the single-device block.
    ``frames`` and ``active`` are global; ``state`` is the rank's shard as
    `stream_step` takes it and comes back placed the same way; the
    `MegastepOut` (trajectories, ``frames_consumed``, rasters, counters)
    is global."""
    _check_stream(program, backend)
    if backend == "float" and mesh is not None:
        raise _no_mesh(backend)
    frames = torch.as_tensor(frames, device=program.device)
    if frames.dim() < 3:
        raise ValueError(f"stream_megastep takes a (K, B, *in_shape) frame "
                         f"block, got shape {tuple(frames.shape)}")
    k, b = int(frames.shape[0]), int(frames.shape[1])
    if k < 1:
        raise ValueError("stream_megastep needs K >= 1 frames per block")
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.int32, device=frames.device)
        live = (torch.arange(k, dtype=torch.int32, device=frames.device)[:, None]
                < act[None, :])
        frames = torch.where(live.reshape(k, b, *([1] * (frames.dim() - 2))),
                             frames, torch.zeros((), dtype=frames.dtype,
                                                 device=frames.device))
        consumed = torch.clamp(act, max=k)
    else:
        consumed = torch.full((b,), k, dtype=torch.int32, device=frames.device)
    if backend == "float":
        return _float_megastep(program, state, frames, consumed,
                               emit_rasters)
    flags = _stream_flags(backend, use_sparse, block_b, gate_granularity,
                          event_crossover)
    flags["fold_events"] = fold_events
    if mesh is not None:
        split, replicated, state, frames = _mesh_stream_in(state, frames, 1,
                                                           mesh)
        flags.update(mesh=mesh, split=split)
    v_enc, spk = state.vs[0], []
    for t in range(k):
        v_enc, s = encoder_step(program, v_enc, frames[t])
        spk.append(s)
    spikes_enc = torch.stack(spk)
    conv_maps, v_convs, conv_skips, flat, rasters_fc, v_stack, skips = \
        _on_macro(program, spikes_enc, True, flags, state)
    ro_in = rasters_fc[-1] if rasters_fc else flat
    v_traj = state.vs[-1][None] + torch.cumsum(
        int_matmul(ro_in, program.fc_stack[-1].w), dim=0, dtype=torch.int32)
    v_out = v_stack[-1]
    new_vs = (v_enc,) + tuple(v_convs) + tuple(v_stack)
    rasters = ([spikes_enc] + list(conv_maps) + list(rasters_fc)
               if emit_rasters else None)
    if mesh is not None:
        v_traj = gather_lanes(v_traj, 1, split, mesh)
        v_out = gather_lanes(v_out, 0, split, mesh)
        if rasters is not None:
            rasters = [gather_lanes(r, 1, split, mesh) for r in rasters]
        new_vs = _mesh_state_out(new_vs, split, replicated, mesh)
    return (StreamState(vs=new_vs, t=state.t + k),
            MegastepOut(v_out=v_out, logits=program.logits(v_out),
                        v_out_traj=v_traj,
                        logits_traj=program.logits(v_traj),
                        frames_consumed=consumed, rasters=rasters,
                        skips=skips, conv_skips=conv_skips or None))


def _float_megastep(program: SNNProgram, state: StreamState,
                    frames: torch.Tensor, consumed: torch.Tensor,
                    emit_rasters: bool) -> tuple[StreamState, MegastepOut]:
    """`stream_megastep` on the float backend: K eager `_float_step` ticks
    over the (masked) frame block."""
    vs, v_traj, spk = list(state.vs), [], []
    ws = _float_weights(program)
    for t in range(frames.shape[0]):
        vs, spikes = _float_step(program, vs, frames[t], ws)
        v_traj.append(vs[-1])
        spk.append(spikes)
    v_traj = torch.stack(v_traj)
    return (StreamState(vs=tuple(vs), t=state.t + frames.shape[0]),
            MegastepOut(v_out=vs[-1], logits=program.logits(vs[-1]),
                        v_out_traj=v_traj,
                        logits_traj=program.logits(v_traj),
                        frames_consumed=consumed,
                        rasters=([torch.stack([s[i] for s in spk])
                                  for i in range(len(spk[0]))]
                                 if emit_rasters else None)))


# ---------------------------------------------------------------------------
# Sparsity measurement (host-side accounting)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SparsityReport:
    """Measured event statistics of one execution, the bridge from spike
    rasters to the energy model. Per macro-stack layer i (whose *input*
    raster is the output of neuron layer i): total input events,
    per-timestep occupancy, per-row event counts and the frame count. Built
    from rasters (`sparsity_report`) or from per-neuron spike sums
    (`sparsity_report_from_sums`); both feed `count_network_instructions`
    and the `energy` model."""
    n_in: tuple                   # fan-in per macro-stack layer
    n_out: tuple
    neurons: tuple                # per-layer update kind ("rmp"... | "none")
    events: tuple                 # total input spike events per layer
    frames: int                   # (timestep, example) pairs = T_total * B
    timesteps: int
    batch: int
    occupancy_t: Optional[tuple] = None   # per layer: (T_total,) mean input
                                          # occupancy per timestep (rasters
                                          # only; None from sums)
    layer_frames: Optional[tuple] = None  # per-layer frame counts (conv
                                          # layers run T*B*P frames, one per
                                          # output position; None = every
                                          # layer runs ``frames``)
    row_events: Optional[tuple] = None    # per layer: (n_in,) int64 events
                                          # per input row over all frames

    @property
    def frames_by_layer(self) -> tuple:
        """Per-layer frame counts: ``layer_frames`` when set, else
        ``frames`` for every layer."""
        return (self.layer_frames if self.layer_frames is not None
                else tuple(self.frames for _ in self.n_in))

    @property
    def layer_sparsity(self) -> tuple:
        """1 - events / possible events, per layer input (0.0 for a
        zero-frame execution: no skip is claimed)."""
        return tuple(1.0 - e / (f * n) if f * n else 0.0
                     for e, n, f in zip(self.events, self.n_in,
                                        self.frames_by_layer))

    @property
    def overall_sparsity(self) -> float:
        """Event-weighted input sparsity, all layers pooled (0.0 for a
        zero-frame execution)."""
        possible = sum(f * n for n, f in zip(self.n_in, self.frames_by_layer))
        return 1.0 - sum(self.events) / possible if possible else 0.0

    @property
    def silent_timestep_fraction(self) -> tuple:
        """Per layer: the fraction of timesteps whose whole-batch input
        raster is silent (None per layer without per-timestep occupancy)."""
        if self.occupancy_t is None:
            return tuple(None for _ in self.n_in)
        return tuple(float(np.mean(np.asarray(o) == 0.0))
                     for o in self.occupancy_t)

    @property
    def macro_timesteps(self) -> int:
        """Macro-timesteps executed: every frame of a layer runs its
        layer's column tiles of macros once (`energy.
        measured_edp_per_neuron_timestep` normalizes by this)."""
        return sum(f * mapping.fc_tiling(ni, no).col_tiles
                   for ni, no, f in zip(self.n_in, self.n_out,
                                        self.frames_by_layer))

    @property
    def row_skip_counts(self) -> tuple:
        """Per layer: silent (frame, input-row) pairs, the AccW2V gate
        sites an event-driven executor skips."""
        return tuple(f * n - e
                     for e, n, f in zip(self.events, self.n_in,
                                        self.frames_by_layer))

    @property
    def skipped_row_fraction(self) -> float:
        """Fraction of all (frame, row) gate sites that were silent
        (numerically ``overall_sparsity``)."""
        return self.overall_sparsity

    def block_event_counts(self, granularity: int) -> tuple:
        """Per layer: (n_blocks,) input-event totals per row block at gate
        ``granularity``, the blocks `kernel.skip_layout` assigns skip
        columns to (128/G rows each at G > 1, the whole fan-in at 1). Each
        layer's blocks sum to its event count."""
        if self.row_events is None:
            raise ValueError("block_event_counts needs per-row event "
                             "columns; build the report from rasters or "
                             "spike sums (row_events=None)")
        if granularity not in GATE_GRANULARITIES:
            raise ValueError(f"gate granularity must be one of "
                             f"{GATE_GRANULARITIES}, got {granularity}")
        out = []
        for rows in self.row_events:
            rows = np.asarray(rows)
            bw = len(rows) if granularity == 1 else LANE // granularity
            nb = -(-len(rows) // bw)
            padded = np.zeros(nb * bw, rows.dtype)
            padded[:len(rows)] = rows
            out.append(padded.reshape(nb, bw).sum(axis=1))
        return tuple(out)

    def instruction_counts(self) -> isa.InstrCount:
        """Event statistics -> instruction cycles (the same counts as
        counting the rasters: both go through
        `isa.count_layer_instructions_from_events`)."""
        counts = isa.InstrCount()
        for ni, no, neuron, ev, f in zip(self.n_in, self.n_out, self.neurons,
                                         self.events, self.frames_by_layer):
            counts += isa.count_layer_instructions_from_events(
                ev, f, ni, no, neuron)
        return counts

    def skipped_instruction_counts(self) -> isa.InstrCount:
        """AccW2V cycles event-driven execution never issued: those of
        every silent (frame, input-row) pair (executed + skipped is the
        dense tally at sparsity 0)."""
        counts = isa.InstrCount()
        for ni, no, ev, f in zip(self.n_in, self.n_out, self.events,
                                 self.frames_by_layer):
            counts += isa.count_skipped_instructions_from_events(
                ev, f, ni, no)
        return counts


def _report_geometry(program: SNNProgram) -> tuple:
    stack = program.macro_stack
    return (tuple(ly.n_in for ly in stack), tuple(ly.n_out for ly in stack),
            tuple("none" if ly.kind == "readout" else program.neuron
                  for ly in stack))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stack_input_rasters(program: SNNProgram, rasters: list) -> list:
    """The trailing len(macro_stack) rasters, as (T, frames, n_in) host
    arrays: the input raster of each macro-stack layer, a conv layer's
    (T, B, H, W, C) spike maps lowered to their im2col patch raster (the
    event stream the macro takes)."""
    stack = program.macro_stack
    if len(rasters) < len(stack):
        raise ValueError(f"need one input raster per macro-stack layer "
                         f"({len(stack)}), got {len(rasters)}")
    out = []
    for spec, raster in zip(stack, rasters[-len(stack):]):
        if spec.kind == "conv":
            raster = mapping.im2col_raster(torch.as_tensor(raster),
                                           spec.w.shape[0], spec.stride)
        r = _host(raster)
        out.append(r.reshape(r.shape[0], -1, spec.n_in))
    return out


def sparsity_report(program: SNNProgram, rasters: list) -> SparsityReport:
    """Exact report from per-layer input rasters (`NetResult.rasters`):
    rasters[i] is (T_total, B, n_in_i) for macro-stack layer i, or the
    (T_total, B, H, W, C) input spike maps of a conv layer, whose events
    are counted per output position as the macro issues them."""
    if rasters is None:
        raise ValueError("sparsity_report needs spike rasters; run the "
                         "backend with emit_rasters=True")
    n_in, n_out, neurons = _report_geometry(program)
    rs = _stack_input_rasters(program, rasters)
    T = rs[0].shape[0]
    B = int(rs[-1].shape[1])                  # fc rasters carry the batch
    return SparsityReport(
        n_in=n_in, n_out=n_out, neurons=neurons,
        events=tuple(int(r.astype(np.int64).sum()) for r in rs),
        frames=T * B, timesteps=T, batch=B,
        occupancy_t=tuple(r.mean(axis=(1, 2)) for r in rs),
        layer_frames=tuple(T * r.shape[1] for r in rs),
        row_events=tuple(r.astype(np.int64).sum(axis=(0, 1)) for r in rs))


def sparsity_report_from_sums(program: SNNProgram, spike_sums: list,
                              timesteps: int) -> SparsityReport:
    """Raster-free report from per-neuron spike counts: spike_sums[i] is
    the (B, ...) spike-count total of neuron layer i over ``timesteps``;
    the last len(macro_stack) of them feed the macro stack. A conv-fed
    layer sees each input pixel once per covering patch, and im2col is
    linear, so its patch event total is ``im2col(sum map).sum()``, exact.
    Per-timestep occupancy is not recoverable (occupancy_t=None)."""
    n_in, n_out, neurons = _report_geometry(program)
    stack = program.macro_stack
    sums = spike_sums[-len(stack):]
    if len(sums) != len(n_in):
        raise ValueError(f"need one spike-sum per macro-stack layer input "
                         f"({len(n_in)}), got {len(spike_sums)}")
    B = int(sums[0].shape[0])
    events, layer_frames, row_events = [], [], []
    for spec, s in zip(stack, sums):
        if spec.kind == "conv":
            patches = _host(mapping.im2col(torch.as_tensor(s),
                                           spec.w.shape[0], spec.stride))
            # int64 per element before summing: the counts are integers,
            # but float accumulation stops being exact above 2**24
            rows = patches.astype(np.int64).reshape(-1, spec.n_in).sum(axis=0)
            layer_frames.append(timesteps * B
                                * patches.shape[1] * patches.shape[2])
        else:
            rows = _host(s).astype(np.int64).reshape(-1, spec.n_in).sum(axis=0)
            layer_frames.append(timesteps * B)
        row_events.append(rows)
        events.append(int(rows.sum()))
    return SparsityReport(
        n_in=n_in, n_out=n_out, neurons=neurons, events=tuple(events),
        frames=timesteps * B, timesteps=timesteps, batch=B,
        layer_frames=tuple(layer_frames), row_events=tuple(row_events))


def count_network_instructions(program: SNNProgram, rasters: list = None, *,
                               report: Optional[SparsityReport] = None
                               ) -> isa.InstrCount:
    """Instruction cycles of a whole execution: ``rasters[i]`` is the input
    raster of macro-stack layer i (conv layers take their input spike maps,
    lowered to im2col patch rasters here), so identical rasters give
    identical counts on every backend; row-tiled layers include the AccV2V
    partial-sum reduction. Or pass a `SparsityReport` (``report=``), the
    raster-free route; both share one counting implementation."""
    if report is not None:
        return report.instruction_counts()
    if rasters is None:
        raise ValueError("instruction counting needs spike rasters (run the "
                         "backend with emit_rasters=True) or a "
                         "SparsityReport")
    counts = isa.InstrCount()
    for spec, r in zip(program.macro_stack,
                       _stack_input_rasters(program, rasters)):
        counts += isa.count_layer_instructions(
            r, spec.n_in, spec.n_out,
            "none" if spec.kind == "readout" else program.neuron)
    return counts
