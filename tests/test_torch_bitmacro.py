"""The port's bit-level macro oracle (repro_torch.core.macro, the ISA-level
ops of repro_torch.core.isa, mapping.tile_weights and the ``bitmacro``
backend) against the JAX package's, and against the port's own word-level
paths.

Inputs are seeded numpy; programs are JAX programs compiled with
``validate=False`` in wrap mode and carried across with
`program_from_arrays`. Every comparison is exact: the oracle is integer
and bit-level. Shapes are tiny because the bit-level model loops over
bits in Python: fan-in 130 and 200 (row tiles reduced by AccV2V), a conv
layer (im2col frames), 14 frames (a second bank of 13 neuron sets).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SpikingConfig as JaxSpiking  # noqa: E402
from repro.configs.impulse_snn import SNNModelConfig as JaxCfg  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import macro as jmacro  # noqa: E402
from repro.core import mapping as jmapping  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import snn as jsnn  # noqa: E402
from repro_torch.core import isa, macro, mapping, pipeline  # noqa: E402
from test_torch_pipeline import carry_across  # noqa: E402

NEURONS = ("if", "lif", "rmp")


def test_physical_layout_and_encodings_match_jax():
    assert macro.physical_layout_check()
    for w in range(-32, 32):
        np.testing.assert_array_equal(macro.encode_w(w), jmacro.encode_w(w))
        assert macro.decode_w(macro.encode_w(w)) == w
    for v in range(-1024, 1024, 7):
        np.testing.assert_array_equal(macro.encode_v(v), jmacro.encode_v(v))
        assert macro.decode_v(macro.encode_v(v)) == v
    with pytest.raises(ValueError):
        macro.encode_w(40)


@pytest.mark.parametrize("mode", ["CS", "CF"])
def test_blfa_unit_add_matches_jax(mode):
    rng = np.random.default_rng(3)
    for _ in range(200):
        a = rng.integers(0, 2, 12).astype(np.uint8)
        b = rng.integers(0, 2, 12).astype(np.uint8)
        a[macro.GUARD] = 0
        got = macro.blfa_unit_add(a, b, mode)
        want = jmacro.blfa_unit_add(a, b, mode)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("neuron", NEURONS)
def test_bitmacro_and_isa_match_jax_and_each_other(neuron):
    """Seeded timesteps on one macro: the port's BitMacro equals JAX's bit
    for bit (every V and const bit, spike buffers, cycle counts), and the
    port's ISA ops (wrap) give the same V, spikes and counts."""
    rng = np.random.default_rng(10 + len(neuron))
    wq = rng.integers(-31, 32, (isa.MACRO_IN, isa.MACRO_OUT)).astype(np.int8)
    th, leak = 40, 3
    bm = macro.BitMacro.from_weights(wq, threshold=th, leak=leak)
    jbm = jmacro.BitMacro.from_weights(wq, threshold=th, leak=leak)
    st = isa.make_state(wq, threshold=th, leak=leak, clamp_mode="wrap")
    total = isa.InstrCount()
    for t in range(5):
        spikes_in = rng.random(isa.MACRO_IN) < 0.2
        set_idx = t % 3
        out = bm.timestep(set_idx, spikes_in, neuron)
        np.testing.assert_array_equal(out,
                                      jbm.timestep(set_idx, spikes_in, neuron))
        st, out_isa, cnt = isa.timestep(st, set_idx, spikes_in, neuron)
        total += cnt
        np.testing.assert_array_equal(out, out_isa.numpy())
        np.testing.assert_array_equal(bm.read_v(set_idx),
                                      st.vmem[set_idx].numpy())
    np.testing.assert_array_equal(bm.vbits, jbm.vbits)
    np.testing.assert_array_equal(bm.spike_buf, jbm.spike_buf)
    for name in jbm.const:
        np.testing.assert_array_equal(bm.const[name], jbm.const[name])
    assert tuple(bm.counts) == tuple(jbm.counts) == tuple(total)
    partial = bm.transfer_v(0)
    np.testing.assert_array_equal(partial, jbm.transfer_v(0))
    bm.acc_v2v(1, partial, 0)
    jbm.acc_v2v(1, partial, 0)
    np.testing.assert_array_equal(bm.vbits, jbm.vbits)


@pytest.mark.parametrize("clamp", ["saturate", "wrap"])
@pytest.mark.parametrize("neuron", NEURONS)
def test_isa_ops_match_jax(neuron, clamp):
    """Each ISA op on seeded states equals JAX's: acc_w2v, acc_v2v (plain
    and conditional), spike_check, reset_v, neuron_update and timestep."""
    rng = np.random.default_rng(20 + len(neuron) + len(clamp))
    wq = rng.integers(-31, 32, (isa.MACRO_IN, isa.MACRO_OUT)).astype(np.int8)
    st = isa.make_state(wq, threshold=30, leak=2, reset=1, clamp_mode=clamp)
    jst = jisa.make_state(wq, threshold=30, leak=2, reset=1,
                          clamp_mode=clamp)

    def same(a, b):
        np.testing.assert_array_equal(a.vmem.numpy(), np.asarray(b.vmem))
        np.testing.assert_array_equal(a.spike_buf.numpy(),
                                      np.asarray(b.spike_buf))

    for step in range(40):
        set_idx, cycle = int(rng.integers(0, 13)), int(rng.integers(0, 2))
        op = step % 6
        if op == 0:
            row = int(rng.integers(0, 128))
            st = isa.acc_w2v(st, set_idx, row, cycle)
            jst = jisa.acc_w2v(jst, set_idx, row, cycle)
        elif op == 1:
            add = rng.integers(-900, 900, 12).astype(np.int32)
            cond = bool(rng.integers(0, 2))
            st = isa.acc_v2v(st, set_idx, torch.from_numpy(add), cycle, cond)
            jst = jisa.acc_v2v(jst, set_idx, jnp.asarray(add), cycle, cond)
        elif op == 2:
            st = isa.spike_check(st, set_idx, cycle)
            jst = jisa.spike_check(jst, set_idx, cycle)
        elif op == 3:
            st = isa.reset_v(st, set_idx, cycle)
            jst = jisa.reset_v(jst, set_idx, cycle)
        elif op == 4:
            st, s, c = isa.neuron_update(st, set_idx, neuron)
            jst, js, jc = jisa.neuron_update(jst, set_idx, neuron)
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            assert tuple(c) == tuple(jc)
        else:
            spikes = rng.random(128) < 0.3
            st, s, c = isa.timestep(st, set_idx, spikes, neuron)
            jst, js, jc = jisa.timestep(jst, set_idx, spikes, neuron)
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            assert tuple(c) == tuple(jc)
        same(st, jst)
    with pytest.raises(ValueError):
        isa.make_state(wq[:10], threshold=1)


@pytest.mark.parametrize("shape", [(130, 14), (12, 12), (300, 25), (5, 1)])
def test_tile_weights_and_untile_outputs_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    w = rng.integers(-31, 32, shape).astype(np.int8)
    np.testing.assert_array_equal(mapping.tile_weights(w),
                                  jmapping.tile_weights(w))
    v = rng.integers(-9, 9, (-(-shape[1] // 12), 12))
    np.testing.assert_array_equal(mapping.untile_outputs(v, shape[1]),
                                  jmapping.untile_outputs(v, shape[1]))


@pytest.mark.parametrize("neuron", NEURONS)
def test_bitmacro_layer_reduction_golden(neuron):
    """A 200 -> 20 layer (2 x 2 macros, 15 frames: two banks) on the port's
    bit-level macros equals JAX's `_bitmacro_layer` and the port's
    word-level layer; its cycles equal the analytic count."""
    rng = np.random.default_rng(5)
    wq = rng.integers(-31, 32, (200, 20)).astype(np.int8)
    inp = rng.random((3, 15, 200)) < 0.3
    out, v, counts = pipeline._bitmacro_layer(inp, wq, 60, 2, neuron)
    jout, jv, jcounts = jpipe._bitmacro_layer(inp, wq, 60, 2, neuron)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(v, jv)
    assert tuple(counts) == tuple(jcounts)
    vr = torch.zeros((15, 20), dtype=torch.int32)
    for t in range(3):
        vr, s = isa.layer_timestep_int(
            vr, torch.from_numpy(wq), torch.from_numpy(inp[t].astype(np.int32)),
            neuron=neuron, threshold=60, leak=2, clamp_mode="wrap")
        np.testing.assert_array_equal(out[t], s.numpy())
    np.testing.assert_array_equal(v, vr.numpy())
    assert counts == isa.count_layer_instructions(inp.astype(np.int8), 200,
                                                  20, neuron)


def fc_programs(sizes, neuron, seed, clamp="wrap"):
    cfg = JaxCfg(arch_id="bitmacro-test", layer_sizes=sizes,
                 spiking=JaxSpiking(neuron=neuron, timesteps=2, threshold=1.0,
                                    leak=0.0625, w_bits=6, v_bits=11),
                 timesteps=2)
    jprog = jpipe.compile_network(
        cfg, jsnn.init_fc_snn(jax.random.PRNGKey(seed), cfg), domain="int",
        clamp_mode=clamp, validate=False)
    return jprog, carry_across(jprog)


def conv_programs(neuron, seed):
    cfg = JaxCfg(arch_id="bitmacro-conv", conv_spec=((3, 3, 1), (5, 3, 2)),
                 in_shape=(6, 6, 1), layer_sizes=(3 * 3 * 5, 6, 2),
                 spiking=JaxSpiking(neuron=neuron, timesteps=2, threshold=1.0,
                                    leak=0.0625, w_bits=6, v_bits=11),
                 timesteps=2, task="multiclass")
    jprog = jpipe.compile_network(
        cfg, jsnn.init_lenet_snn(jax.random.PRNGKey(seed), cfg), domain="int",
        clamp_mode="wrap", validate=False)
    return jprog, carry_across(jprog)


def check_run(jprog, prog, x):
    """bitmacro on the port == bitmacro on JAX == the port's int_ref, with
    macro_counts equal to the raster count less the readout's."""
    xs = np.array(x)
    got = pipeline.run_network(prog, torch.from_numpy(xs), "bitmacro")
    want = jpipe.run_network(jprog, jnp.asarray(xs), "bitmacro")
    ref = pipeline.run_network(prog, torch.from_numpy(xs), "int_ref")
    for g, w, r in zip(got.rasters + got.v_final,
                       want.rasters + want.v_final,
                       ref.rasters + ref.v_final):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, r)
    np.testing.assert_array_equal(got.logits.numpy(), np.asarray(want.logits))
    counts = got.aux["macro_counts"]
    assert tuple(counts) == tuple(want.aux["macro_counts"])
    ro = prog.macro_stack[-1]
    readout = isa.count_layer_instructions(ref.rasters[-1], ro.n_in,
                                           ro.n_out, "none")
    total = pipeline.count_network_instructions(prog, ref.rasters)
    assert tuple(counts + readout) == tuple(total)
    return got


@pytest.mark.parametrize("neuron", NEURONS)
def test_bitmacro_backend_row_tiles_and_banks(neuron):
    """Fan-in 130 (two row tiles, AccV2V) and 14 examples (a second bank)."""
    jprog, prog = fc_programs((130, 14, 3), neuron, seed=len(neuron))
    rng = np.random.default_rng(1)
    x = (rng.random((3, 14, 130)) * 1.5).astype(np.float32)
    got = check_run(jprog, prog, x)
    assert got.aux["macro_counts"].acc_v2v > 0


@pytest.mark.parametrize("neuron", ["lif", "rmp"])
def test_bitmacro_backend_conv(neuron):
    """A conv program: the on-macro conv runs one neuron set per (example,
    output position), 18 frames over two banks."""
    jprog, prog = conv_programs(neuron, seed=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32) * 2
    check_run(jprog, prog, np.broadcast_to(x[None], (3, 2, 6, 6, 1)))


def test_bitmacro_rejects_saturate_and_has_no_stream():
    _, prog = fc_programs((20, 6, 2), "if", seed=0, clamp="saturate")
    with pytest.raises(ValueError, match="wrap"):
        pipeline.run_network(prog, torch.zeros((2, 1, 20)), "bitmacro")
    assert "bitmacro" in pipeline.BACKENDS
    assert "bitmacro" not in pipeline.STREAM_BACKENDS
    with pytest.raises(KeyError):
        pipeline.init_stream_state(prog, 1, "bitmacro")


def test_register_backend():
    """`register_backend` adds a backend to the `run_network` table."""
    @pipeline.register_backend("test_twice")
    def twice(program, xs):
        return pipeline.run_int_ref(program, xs)
    try:
        _, prog = fc_programs((20, 6, 2), "if", seed=0)
        xs = torch.ones((2, 1, 20))
        assert torch.equal(pipeline.run_network(prog, xs, "test_twice").v_out,
                           pipeline.run_network(prog, xs).v_out)
    finally:
        del pipeline.BACKENDS["test_twice"]
