"""The port's wkv6 recurrence (repro_torch.kernels.wkv6) against the JAX
package's `wkv6_sequential` (the ground-truth oracle) and its model-layout
`ops.wkv6(use_pallas=False)` (the chunked jnp form), on seeded numpy inputs.

Tolerance 2e-4 relative and absolute, the JAX package's own for its wkv6
tests: both sides compute in float32, in different summation orders.

On the CPU the wrapper runs its plain version; the `cuda`-marked tests hold
the CUDA kernel against it on the card (``pytest -m cuda``). The
differentiable route (``use_kernel=False``, the chunked form the language
models' loss takes) is held against JAX's padded `ops.wkv6` and its
`jax.grad`. JAX is
imported inside the tests that need it, so the card-only tests also run
where JAX is not installed.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.wkv6 import kernel, ops, ref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
WKV_SHAPES = [
    # B, T, H, K, V  (the JAX package's tests/test_kernels.py shapes)
    (2, 64, 2, 64, 64),
    (1, 128, 3, 64, 64),
    (2, 100, 2, 32, 32),     # ragged T
    (1, 192, 1, 16, 64),     # K != V
]
STRONG = math.exp(-math.e)   # the strongest decay the model's clip allows


def wkv_inputs(B, T, H, K, V, seed=0, w_lo=0.6, w_const=None):
    """Model-layout inputs as the JAX tests draw them: r, k, v ~ N(0, 0.25),
    w ~ U[w_lo, 0.999) (or the constant ``w_const``), u ~ N(0, 0.09)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, T, H, V)).astype(np.float32) * 0.5
    w = (np.full((B, T, H, K), w_const, np.float32) if w_const is not None
         else rng.uniform(w_lo, 0.999, (B, T, H, K)).astype(np.float32))
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    return r, k, v, w, u


def to_bh(x):
    """(B, T, H, D) numpy -> (B*H, T, D)."""
    B, T, H, D = x.shape
    return np.ascontiguousarray(np.moveaxis(x, 2, 1).reshape(B * H, T, D))


def bh_inputs(r, k, v, w, u):
    B, _, H, K = r.shape
    ub = np.ascontiguousarray(np.broadcast_to(u[None], (B, H, K))
                              .reshape(B * H, K))
    return to_bh(r), to_bh(k), to_bh(v), to_bh(w), ub


def t(x):
    return torch.from_numpy(np.array(x))


def jax_sequential(r, k, v, w, u, s0=None):
    """JAX `wkv6_sequential` on model-layout numpy inputs, in the BH layout."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ref import wkv6_sequential
    args = [jnp.asarray(x) for x in bh_inputs(r, k, v, w, u)]
    y, s = wkv6_sequential(*args, None if s0 is None else jnp.asarray(s0))
    return np.asarray(y), np.asarray(s)


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_wrapper_matches_jax(shape):
    """Model layout, no initial state: the port's `ops.wkv6` against JAX
    `ops.wkv6(use_pallas=False)` and against JAX `wkv6_sequential`."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    B, T, H, K, V = shape
    inputs = wkv_inputs(B, T, H, K, V, seed=sum(shape))
    y, s = ops.wkv6(*map(t, inputs))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, T, H, V) and s.shape == (B, H, K, V)
    y_j, s_j = jax_wkv6(*map(jnp.asarray, inputs), use_pallas=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    y_seq, s_seq = jax_sequential(*inputs)
    np.testing.assert_allclose(to_bh(y.numpy()), y_seq, **TOL)
    np.testing.assert_allclose(s.numpy().reshape(B * H, K, V), s_seq, **TOL)


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_sequential_matches_jax_sequential(shape):
    B, T, H, K, V = shape
    inputs = wkv_inputs(B, T, H, K, V, seed=7 + sum(shape))
    s0 = np.random.default_rng(1).standard_normal((B * H, K, V)).astype(
        np.float32)
    y, s = ref.wkv6_sequential(*map(t, bh_inputs(*inputs)), t(s0))
    y_j, s_j = jax_sequential(*inputs, s0=s0)
    np.testing.assert_allclose(y.numpy(), y_j, **TOL)
    np.testing.assert_allclose(s.numpy(), s_j, **TOL)


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_chunked_matches_jax_chunked(shape):
    """The port's chunked form against JAX `wkv6_chunked` at a chunk that
    divides T (20 for the ragged T = 100, else 64)."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ref import wkv6_chunked as jax_chunked
    B, T, H, K, V = shape
    chunk = 64 if T % 64 == 0 else 20
    bh = bh_inputs(*wkv_inputs(B, T, H, K, V, seed=11 + sum(shape)))
    y, s = ref.wkv6_chunked(*map(t, bh), chunk=chunk)
    y_j, s_j = jax_chunked(*map(jnp.asarray, bh), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)


def test_chunked_refuses_a_ragged_sequence():
    bh = bh_inputs(*wkv_inputs(1, 10, 1, 16, 16))
    with pytest.raises(ValueError, match="T % chunk"):
        ref.wkv6_chunked(*map(t, bh), chunk=4)


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_s0_continuation_matches_jax(shape):
    """Two halves, the second from the first's state, equal the whole, and
    the second half equals JAX `ops.wkv6` from the same state."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    B, T, H, K, V = shape
    r, k, v, w, u = wkv_inputs(B, T, H, K, V, seed=3 + sum(shape))
    h = T // 2 + 1
    y_all, s_all = ops.wkv6(*map(t, (r, k, v, w, u)))
    y1, s1 = ops.wkv6(*map(t, (r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)))
    y2, s2 = ops.wkv6(*map(t, (r[:, h:], k[:, h:], v[:, h:], w[:, h:], u)),
                      s0=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), s_all.numpy(), **TOL)
    y2_j, s2_j = jax_wkv6(*(jnp.asarray(x[:, h:]) for x in (r, k, v, w)),
                          jnp.asarray(u), s0=jnp.asarray(s1.numpy()),
                          use_pallas=False)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y2_j), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), **TOL)


@pytest.mark.parametrize("K,V", [(64, 64), (16, 64)])
def test_decode_step_matches_jax(K, V):
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6_decode_step as jax_step
    B, H = 3, 2
    rng = np.random.default_rng(K + V)
    r, k, w = (rng.standard_normal((B, H, K)).astype(np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-w))
    v = rng.standard_normal((B, H, V)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    s = rng.standard_normal((B, H, K, V)).astype(np.float32)
    y, s_new = ops.wkv6_decode_step(*map(t, (r, k, v, w, u, s)))
    y_j, s_j = jax_step(*map(jnp.asarray, (r, k, v, w, u, s)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_j), **TOL)


def test_decode_step_equals_a_one_step_prefill():
    B, T, H, K, V = 2, 9, 2, 32, 32
    r, k, v, w, u = wkv_inputs(B, T, H, K, V, seed=5)
    y, s = ops.wkv6(*map(t, (r[:, :-1], k[:, :-1], v[:, :-1], w[:, :-1], u)))
    y1, s1 = ops.wkv6(*map(t, (r[:, -1:], k[:, -1:], v[:, -1:], w[:, -1:],
                               u)), s0=s)
    y_d, s_d = ops.wkv6_decode_step(*(t(x[:, -1]) for x in (r, k, v, w)),
                                    t(u), s)
    np.testing.assert_allclose(y_d.numpy(), y1[:, 0].numpy(), **TOL)
    np.testing.assert_allclose(s_d.numpy(), s1.numpy(), **TOL)


@pytest.mark.parametrize("B,H", [(1, 2), (2, 1)])
def test_strong_decay_matches_jax_sequential(B, H):
    """w = exp(-e) on every step (the model's clip at 1), T = 64, K = 64:
    the port's wrapper stays finite and equals JAX `wkv6_sequential`."""
    T, K, V = 64, 64, 64
    inputs = wkv_inputs(B, T, H, K, V, seed=17, w_const=STRONG)
    y, s = ops.wkv6(*map(t, inputs))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_j, s_j = jax_sequential(*inputs)
    np.testing.assert_allclose(to_bh(y.numpy()), y_j, **TOL)
    np.testing.assert_allclose(s.numpy().reshape(B * H, K, V), s_j, **TOL)


def test_chunked_form_overflows_at_strong_decay():
    """Why nothing on the serving path takes the chunked form: over a
    64-step chunk at w = exp(-e) its exp(-L) scaling passes float32's range
    (JAX's `wkv6_chunked` does the same), while the sequential form stays
    finite."""
    bh = bh_inputs(*wkv_inputs(1, 64, 1, 64, 64, seed=17, w_const=STRONG))
    y_c, _ = ref.wkv6_chunked(*map(t, bh), chunk=64)
    y_s, _ = ref.wkv6_sequential(*map(t, bh))
    assert not torch.isfinite(y_c).all()
    assert torch.isfinite(y_s).all()


def test_cuda_binding_refuses_cpu_tensors():
    """The kernel's binding never runs anything on the CPU."""
    bh = [t(x) for x in bh_inputs(*wkv_inputs(1, 4, 1, 16, 16))]
    s0 = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv6_cuda(*bh[:4], bh[4], s0)


def test_cuda_binding_refuses_inputs_that_require_grad():
    """The kernel is forward-only: in grad mode an input that requires a
    gradient is refused before anything else is checked (its outputs would
    carry no graph, and the gradient upstream of the recurrence would be
    silently lost); under no_grad the same call reaches the device check."""
    bh = [t(x) for x in bh_inputs(*wkv_inputs(1, 4, 1, 16, 16))]
    s0 = torch.zeros((1, 16, 16))
    for i in range(6):
        args = [x.clone() for x in (*bh, s0)]
        args[i].requires_grad_(True)
        with pytest.raises(ValueError, match="forward-only"):
            kernel.wkv6_cuda(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
            kernel.wkv6_cuda(*args)


def grad_inputs(B, T, H, K, V, seed):
    """Model-layout inputs, a random initial state and random cotangents
    of y and the final state, as numpy float32 arrays."""
    rng = np.random.default_rng(seed + 100)
    s0 = rng.standard_normal((B, H, K, V)).astype(np.float32) * 0.5
    gy = rng.standard_normal((B, T, H, V)).astype(np.float32)
    gs = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return wkv_inputs(B, T, H, K, V, seed=seed), s0, gy, gs


@pytest.mark.parametrize("T", [1, 63, 64, 65])
def test_differentiable_route_pads_as_jax(T):
    """``use_kernel=False``: the chunked form with T padded to the chunk of
    64 (w = 1, k = r = v = 0) against JAX `ops.wkv6(use_pallas=False)`,
    which pads the same way, from a carried state; and against the
    sequential form."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    B, H, K, V = 2, 2, 32, 32
    inputs, s0, _, _ = grad_inputs(B, T, H, K, V, seed=T)
    y, s = ops.wkv6(*map(t, inputs), s0=t(s0), use_kernel=False)
    assert y.shape == (B, T, H, V) and s.shape == (B, H, K, V)
    y_j, s_j = jax_wkv6(*map(jnp.asarray, inputs), s0=jnp.asarray(s0),
                        use_pallas=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    y_s, s_s = ops.wkv6(*map(t, inputs), s0=t(s0))
    np.testing.assert_allclose(y.numpy(), y_s.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_s.numpy(), **TOL)


@pytest.mark.parametrize("T", [40, 100])
def test_differentiable_route_gradients_match_jax(T):
    """Gradients of <y, gy> + <s_out, gs> with respect to r, k, v, w, u
    and s0 through the route, against `jax.grad` of JAX's `ops.wkv6`
    (the padded `wkv6_chunked`), each within 2e-4 relative L2."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    B, H, K, V = 2, 2, 32, 32
    inputs, s0, gy, gs = grad_inputs(B, T, H, K, V, seed=T)
    xs = [t(x).requires_grad_(True) for x in (*inputs, s0)]
    y, s = ops.wkv6(*xs[:5], s0=xs[5], use_kernel=False)
    obj = (y * t(gy)).sum() + (s * t(gs)).sum()
    grads = torch.autograd.grad(obj, xs)

    def jobj(r, k, v, w, u, s0):
        y, s = jax_wkv6(r, k, v, w, u, s0=s0, use_pallas=False)
        return jnp.sum(y * gy) + jnp.sum(s * gs)
    jgrads = jax.grad(jobj, argnums=tuple(range(6)))(
        *map(jnp.asarray, (*inputs, s0)))
    for name, g, jg in zip("rkvwus", grads, jgrads):
        jg = np.asarray(jg, np.float64)
        err = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert err <= 2e-4, (name, err)


def test_a_chunk_of_16_stays_finite_where_jax_chunk_64_overflows():
    """At the strongest decay the model's clip allows (w = exp(-e) every
    step) JAX's chunked form overflows at its default chunk of 64 (exp(-L)
    over 64 steps is exp(174)), and the port's route does the same. At a
    chunk of 32 the exponent stays inside float32 (exp(87.0)), but r
    exp(L) reaches the edge of its normal range, and JAX's CPU form (which
    flushes subnormals) already misses by 0.046 there; at 16 (exp(43.5))
    both stay finite and equal the sequential form."""
    import jax.numpy as jnp

    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    inputs = wkv_inputs(1, 64, 1, 64, 64, seed=17, w_const=STRONG)
    y64, _ = ops.wkv6(*map(t, inputs), use_kernel=False, chunk=64)
    y64_j, _ = jax_wkv6(*map(jnp.asarray, inputs), use_pallas=False,
                        chunk=64)
    assert not torch.isfinite(y64).all()
    assert not np.isfinite(np.asarray(y64_j)).all()
    y16, s16 = ops.wkv6(*map(t, inputs), use_kernel=False, chunk=16)
    y16_j, s16_j = jax_wkv6(*map(jnp.asarray, inputs), use_pallas=False,
                            chunk=16)
    y_s, s_s = jax_sequential(*inputs)
    assert torch.isfinite(y16).all() and torch.isfinite(s16).all()
    np.testing.assert_allclose(y16.numpy(), np.asarray(y16_j), **TOL)
    np.testing.assert_allclose(s16.numpy(), np.asarray(s16_j), **TOL)
    np.testing.assert_allclose(to_bh(y16.numpy()), y_s, **TOL)
    np.testing.assert_allclose(s16.numpy().reshape(64, 64), s_s[0], **TOL)


@pytest.mark.parametrize("K", kernel.HEAD_SIZES)
@pytest.mark.parametrize("V", kernel.HEAD_SIZES)
def test_launch_plan_fits_a_hopper_block(K, V):
    """Every (K, V) the kernel takes: a tile of ROWS x CPT state elements
    a thread, row groups that tile K, column blocks that tile V, whole
    warps (or the one half warp of K = V = 16), and shared memory within a
    Hopper block's."""
    for BH in (1, 64, 264):
        plan = kernel.launch_plan(BH, K, V)
        assert plan["threads"] % 16 == 0 and plan["threads"] <= 1024
        assert plan["groups"] * kernel.ROWS == K
        assert plan["threads"] * kernel.CPT == plan["groups"] * plan["cols"]
        assert V % plan["cols"] == 0 and plan["cols"] in (16, 32)
        assert plan["cols"] % kernel.CPT == 0
        assert plan["grid"] == BH * V // plan["cols"]
        assert plan["chunk"] == kernel.CHUNK
        assert plan["smem_bytes"] % 16 == 0
        assert plan["smem_bytes"] <= kernel.SMEM_LIMIT


def test_launch_plan_at_the_served_head():
    """RWKV6-7B's heads (K = V = 64) at batch 1: 128 blocks of 4 warps,
    one warp a scheduler of an SM, and 184 KiB of shared memory each (above
    the 48 KiB default, so the launcher raises the kernel's dynamic
    shared-memory limit)."""
    plan = kernel.launch_plan(64, 64, 64)
    assert (plan["grid"], plan["threads"], plan["smem_bytes"]) == (
        128, 128, 188_416)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = [
    # B, T, H, K, V, w_const
    (1, 1, 64, 64, 64, None),
    (1, 1024, 64, 64, 64, None),
    (4, 100, 64, 64, 64, None),
    (1, 1024, 64, 64, 64, STRONG),
    (2, 100, 2, 32, 32, None),
    (1, 192, 1, 16, 64, None),
    (1, 33, 3, 64, 16, STRONG),
    # the 32-step chunk's edges, a long prompt, more than one wave of
    # blocks (B*H = 264), K != V both ways
    (1, 31, 4, 64, 64, None),
    (1, 32, 4, 64, 64, STRONG),
    (1, 33, 4, 64, 64, None),
    (1, 65, 4, 64, 64, None),
    (1, 2048, 64, 64, 64, None),
    (4, 40, 66, 64, 64, None),
    (2, 100, 2, 64, 16, None),
    (2, 100, 2, 16, 64, STRONG),
    (1, 50, 3, 16, 16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_the_card(cuda_device, case):
    """The kernel against `ref.wkv6_sequential` on the same CUDA tensors,
    from a random initial state, within 2e-4."""
    B, T, H, K, V, w_const = case
    bh = [t(x).to(cuda_device) for x in
          bh_inputs(*wkv_inputs(B, T, H, K, V, seed=T, w_const=w_const))]
    s0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B * H, K, V)).astype(np.float32)).to(cuda_device)
    y, s = kernel.wkv6_cuda(*bh, s0)
    y_p, s_p = ref.wkv6_sequential(*bh, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_p, **TOL)
    torch.testing.assert_close(s, s_p, **TOL)


@pytest.mark.cuda
def test_differentiable_route_launches_no_kernel_on_the_card(cuda_device):
    """On the card the route differentiates (every input gets a non-zero
    gradient) and launches no kernel; the kernel refuses the same inputs
    in grad mode."""
    from repro_torch import kernels
    xs = [t(x).to(cuda_device).requires_grad_(True)
          for x in wkv_inputs(2, 100, 4, 64, 64)]
    before = kernels.LAUNCH_COUNTS["wkv6"]
    y, s = ops.wkv6(*xs, use_kernel=False)
    grads = torch.autograd.grad(y.square().sum() + s.sum(), xs)
    assert kernels.LAUNCH_COUNTS["wkv6"] == before
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    with pytest.raises(ValueError, match="forward-only"):
        ops.wkv6(*xs)


@pytest.mark.cuda
def test_wrapper_launches_the_kernel_on_the_card(cuda_device):
    from repro_torch import kernels
    inputs = [t(x).to(cuda_device) for x in wkv_inputs(1, 16, 4, 64, 64)]
    before = kernels.LAUNCH_COUNTS["wkv6"]
    ops.wkv6(*inputs)
    assert kernels.LAUNCH_COUNTS["wkv6"] == before + 1
    with pytest.raises(ValueError, match="K and V"):
        ops.wkv6(*[t(x).to(cuda_device) for x in wkv_inputs(1, 4, 1, 8, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("T,h,K,V", [(65, 32, 64, 64), (1024, 513, 64, 64),
                                     (40, 7, 16, 64), (2048, 1024, 64, 16)])
def test_two_halves_continue_from_s0_on_the_card(cuda_device, T, h, K, V):
    """The kernel on steps [0, h) and then [h, T) from the first call's
    state equals the plain version over all T steps."""
    B, H = 1, 4
    bh = [t(x).to(cuda_device) for x in
          bh_inputs(*wkv_inputs(B, T, H, K, V, seed=h, w_const=None))]
    s0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B * H, K, V)).astype(np.float32)).to(cuda_device)
    first = [x[:, :h].contiguous() for x in bh[:4]]
    second = [x[:, h:].contiguous() for x in bh[:4]]
    y1, s1 = kernel.wkv6_cuda(*first, bh[4], s0)
    y2, s2 = kernel.wkv6_cuda(*second, bh[4], s1)
    y_p, s_p = ref.wkv6_sequential(*bh, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_p, **TOL)
    torch.testing.assert_close(s2, s_p, **TOL)


@pytest.mark.cuda
def test_library_plan_matches_the_binding(cuda_device):
    """Loading the library checks its launch plan against `launch_plan`
    for every (K, V); it raises on a difference."""
    assert kernel._lib() is not None
