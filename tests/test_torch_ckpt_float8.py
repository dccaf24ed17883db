"""Checkpoints of bfloat16 and float8 leaves between the packages.

numpy's npz cannot hold bfloat16, float8_e4m3fn or float8_e5m2, so both
packages store such a leaf as its bits (uint16 or uint8) under its dtype's
name in the manifest. A tree of the three dtypes, saved by either package,
restores in the other bit for bit, with a ``like=`` tree and without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager

DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")
#: values each dtype holds exactly, a subnormal and the signs among them
VALUES = np.array([0.5, 1.0, -2.0, 0.0, -0.0, 3.5, -0.125, 2.0 ** -9],
                  np.float32)


def _ml(dtype: str):
    import ml_dtypes
    return getattr(ml_dtypes, dtype)


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a numpy/JAX array as unsigned
    integers."""
    if torch.is_tensor(x):
        signed = torch.int16 if x.element_size() == 2 else torch.int8
        return x.view(signed).numpy().view(
            np.uint16 if x.element_size() == 2 else np.uint8)
    a = np.asarray(x)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint8)


def _leaves(tree: dict) -> list:
    """A tree's leaves in both packages' flattening order (sorted dict
    keys, list items in order)."""
    return list(tree["nested"]) + [tree["w"]]


def _port_tree(dtype: str) -> dict:
    t = torch.from_numpy(VALUES).to(getattr(torch, dtype))
    return {"w": t, "nested": [t.reshape(2, 4), t[:3]]}


def _jax_tree(dtype: str) -> dict:
    import jax.numpy as jnp
    a = jnp.asarray(VALUES.astype(_ml(dtype)))
    return {"w": a, "nested": [a.reshape(2, 4), a[:3]]}


@pytest.mark.parametrize("with_like", [False, True], ids=["bare", "like"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype, with_like):
    """JAX saves, the port restores: each leaf comes back with its dtype
    and its bits."""
    from repro.checkpoint import CheckpointManager as JaxCheckpoints
    jtree = _jax_tree(dtype)
    JaxCheckpoints(str(tmp_path)).save(3, jtree, blocking=True)
    like = _port_tree(dtype) if with_like else None
    step, got = CheckpointManager(str(tmp_path)).restore(like=like)
    assert step == 3
    got = _leaves(got) if with_like else got
    want = _leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("with_like", [False, True], ids=["bare", "like"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_jax(tmp_path, dtype, with_like):
    """The port saves, JAX restores: the manifest names the dtype, so JAX
    rebuilds each leaf from its bits."""
    from repro.checkpoint import CheckpointManager as JaxCheckpoints
    tree = _port_tree(dtype)
    CheckpointManager(str(tmp_path)).save(4, tree, blocking=True)
    like = _jax_tree(dtype) if with_like else None
    step, got = JaxCheckpoints(str(tmp_path)).restore(like=like)
    assert step == 4
    got = _leaves(got) if with_like else list(got)
    want = _leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.dtype(_ml(dtype))
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_round_trip_keeps_bits(tmp_path, dtype):
    """The port's own save and restore keep every bit, NaN included where
    the format has one."""
    t = torch.from_numpy(np.arange(256, dtype=np.uint8).view(np.int8)
                         if dtype != "bfloat16" else
                         np.arange(0, 65536, 257, dtype=np.uint16)
                         .view(np.int16))
    t = t.view(getattr(torch, dtype))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": t}, blocking=True)
    _, (back,) = mgr.restore()
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(_bits(back), _bits(t))
