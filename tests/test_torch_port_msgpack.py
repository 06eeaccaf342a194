"""The port's flax-msgpack codec (`training/flax_msgpack.py`) against
`flax.serialization`: the same bytes for the same tree, the same tree from
the same bytes, bf16 leaves as torch bf16 tensors, chunked records, and a
JAX-package checkpoint read back leaf for leaf."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from peppa_tpu_torch.training import flax_msgpack as fm


def _tree():
    rng = np.random.default_rng(0)
    return {
        "step": np.asarray(7, np.int32),
        "params": {
            "dense": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                      "bias": np.zeros(5, np.float32)},
            "conv": {"kernel": rng.normal(size=(2, 3, 3, 4, 6)
                                          ).astype(np.float32)},
            "ids": np.arange(300, dtype=np.int32),
            "f64": rng.normal(size=(4,)),
            "u8": rng.integers(0, 255, size=(2, 2), dtype=np.uint8),
            "b": np.array([True, False]),
            "empty": np.zeros((0, 3), np.float32),
        },
        "opt_state": {"0": {"count": np.asarray(3, np.int32)}, "1": {},
                      "2": {"mu": {}, "nu": {}}, "none": None},
        "scalars": {"f32": np.float32(2.5), "f64": np.float64(-1.25),
                    "i64": np.int64(-3), "i8": np.int8(5)},
        "python": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                   2 ** 40, -1, -32, -33, -128, -129, -32768, -32769,
                   -2 ** 31, -2 ** 31 - 1, -2 ** 40, 0.5, -1e300, True,
                   False, None, "s" * 40, "t" * 300, b"xy" * 200],
        "wide_map": {f"k{i}": i for i in range(20)},
        "long_list": list(range(20)),
    }


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_bytes_equal_flax():
    tree = _tree()
    assert fm.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


def test_decode_equals_flax_leaf_for_leaf():
    blob = serialization.msgpack_serialize(_tree())
    _same(fm.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_bfloat16_leaves_decode_to_torch_bf16():
    x = (jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7).astype(
        jnp.bfloat16)
    blob = serialization.msgpack_serialize({"w": x, "s": np.asarray(x)[0, 1]})
    got = fm.msgpack_restore(blob)
    want = np.asarray(x).view(np.uint16)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (3, 4)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy().view(
        np.uint16), want)
    assert got["s"].dtype == torch.bfloat16 and got["s"].shape == ()
    assert got["s"].view(torch.int16).item() == int(want[0, 1])
    # and back: flax's bytes
    assert fm.msgpack_serialize({"w": got["w"]}) \
        == serialization.msgpack_serialize({"w": x})


@pytest.mark.parametrize("chunk", [8, 64, 1000])
def test_chunked_records(monkeypatch, chunk):
    """Arrays over MAX_CHUNK_SIZE bytes go out as flax's chunk record (the
    same bytes) and come back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    tree = _tree()
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert fm.msgpack_serialize(tree) == blob
    _same(fm.msgpack_restore(blob), serialization.msgpack_restore(blob))
    big = np.arange(100, dtype=np.float32).reshape(10, 10)
    got = fm.msgpack_restore(serialization.msgpack_serialize(big))
    np.testing.assert_array_equal(got, big)


def test_jax_checkpoint_payload_reads_back(tmp_path):
    """A JAX-package checkpoint (its `save_checkpoint` of a TrainState
    with an optax state) decodes as flax restores it."""
    from types import SimpleNamespace

    import optax

    from peppa_tpu.training.checkpoint import save_checkpoint

    params = {"a": {"kernel": jnp.ones((3, 2))}, "b": jnp.zeros((4,))}
    state = SimpleNamespace(
        step=jnp.asarray(5, jnp.int32), params=params,
        batch_stats={"bn": {"mean": jnp.ones(2), "var": jnp.ones(2)}},
        opt_state=optax.adamw(1e-3).init(params))
    path = tmp_path / "x.ckpt"
    save_checkpoint(str(path), state, {"monitor": None})
    blob = path.read_bytes()
    got = fm.read_checkpoint(str(path))
    _same(got, serialization.msgpack_restore(blob))
    assert set(got) == {"step", "params", "batch_stats", "opt_state"}
    fm.write_checkpoint(str(tmp_path / "y.ckpt"), got)
    assert (tmp_path / "y.ckpt").read_bytes() == blob


def test_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        fm.msgpack_serialize({"t": (1, 2)})  # strict types: no tuples
    with pytest.raises(TypeError):
        fm.msgpack_serialize({1: 2})
    with pytest.raises(ValueError, match="trailing"):
        fm.msgpack_restore(fm.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        fm.msgpack_restore(fm.msgpack_serialize({"a": np.ones(3)})[:-2])
