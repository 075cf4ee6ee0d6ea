"""The port's quantized wire (``tpu_dist_torch/collectives/quant.py``) and
its low-precision floats without ``ml_dtypes``
(``tpu_dist_torch/collectives/_lowp.py``) against the JAX package's
``tpu_dist/collectives/quant.py`` and ``ml_dtypes``: the same inputs give
the same bytes.  Every check here is bit for bit."""

import numpy as np
import pytest
import torch

import ml_dtypes
from tpu_dist.collectives import quant as JQ
from tpu_dist_torch.collectives import _lowp
from tpu_dist_torch.collectives import quant as TQ


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _edge_values():
    """Finite values over the whole float32 range, ±0, subnormals, ±inf and
    NaNs of both signs (and a payload NaN), from one seed."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000).astype(np.float32) * np.exp(
        rng.uniform(-60, 60, 20000)).astype(np.float32)
    bits = np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x00400000,
                     0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x3F808000,
                     0x3F818000, 0x3F80FFFF, 0x7FC00000, 0xFFC00000,
                     0x7F800001, 0xFFBFFFFF, 0x7F800000, 0xFF800000,
                     0x00000000, 0x80000000], np.uint32).view(np.float32)
    f8 = np.array([448, 449, 463.9, 464, 465, -464, -465, 57344, 61439,
                   61440, -61440, 1e-9, -1e-9, 2 ** -9, 2 ** -17],
                  np.float32)
    return np.concatenate([x, bits, f8])


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn",
                                  "float8_e5m2"])
def test_narrowing_rounds_as_ml_dtypes(name):
    x = _edge_values()
    st = np.uint16 if name == "bfloat16" else np.uint8
    want = x.astype(getattr(ml_dtypes, name)).view(st)
    got = _lowp.cast(x, _lowp.LOWP[name])
    assert got.dtype == _lowp.LOWP[name]
    np.testing.assert_array_equal(got.view(st), want)
    # float64 rounds through float32 first, as ml_dtypes does
    x64 = np.array([1 + 2 ** -8 + 2 ** -40, -(1 + 2 ** -8 + 2 ** -40),
                    1e300, -1e-300], np.float64)
    np.testing.assert_array_equal(
        _lowp.cast(x64, _lowp.LOWP[name]).view(st),
        x64.astype(getattr(ml_dtypes, name)).view(st))


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn",
                                  "float8_e5m2"])
def test_widening_and_torch_views_are_exact(name):
    st = np.uint16 if name == "bfloat16" else np.uint8
    bits = np.arange(1 << (16 if st == np.uint16 else 8)).astype(st)
    mine = _lowp.cast(bits.view(_lowp.LOWP[name]), np.float32)
    ref = bits.view(getattr(ml_dtypes, name)).astype(np.float32)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(mine), nan)
    np.testing.assert_array_equal(_u32(mine)[~nan], _u32(ref)[~nan])
    # a tensor crosses as its bit patterns, both ways
    t = _lowp.to_torch(bits.view(_lowp.LOWP[name]))
    assert t.dtype == getattr(torch, name)
    np.testing.assert_array_equal(_lowp.from_torch(t).view(st), bits)


def test_dtype_names_are_the_wire_headers():
    for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        dt = _lowp.decode_dtype(name)
        assert _lowp.dtype_name(dt) == name == np.dtype(
            getattr(ml_dtypes, name)).name
        assert _lowp.is_float(dt) and dt.itemsize == np.dtype(
            getattr(ml_dtypes, name)).itemsize
    assert _lowp.decode_dtype("float32") == np.float32
    assert not _lowp.is_lowp(np.float16) and _lowp.is_float(np.float16)
    with pytest.raises(TypeError):
        _lowp.decode_dtype("not_a_dtype")


@pytest.mark.parametrize("block", [256, 64, 1])
@pytest.mark.parametrize("case", ["random", "zero_block", "subnormal_block",
                                  "inf_block", "nan_block", "partial",
                                  "empty", "huge"])
def test_quantize_dequantize_bytes_equal_jax(block, case):
    rng = np.random.default_rng(block)
    x = rng.standard_normal(4 * 256 + 37).astype(np.float32)
    if case == "zero_block":
        x[:256] = 0.0
    elif case == "subnormal_block":
        x[:256] = np.float32(1e-44)
    elif case == "inf_block":
        x[5] = np.inf
    elif case == "nan_block":
        x[300] = np.nan
    elif case == "partial":
        x = x[:block + 3] if block > 1 else x[:7]
    elif case == "empty":
        x = x[:0]
    elif case == "huge":
        x *= np.float32(1e37)
    q1, s1 = TQ.quantize(x, TQ.QuantScheme(block))
    q2, s2 = JQ.quantize(x, JQ.QuantScheme(block))
    assert q1.dtype == q2.dtype == np.int8
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(_u32(s1), _u32(s2))
    for dt in (np.float32, np.float64):
        d1 = TQ.dequantize(q1, s1, TQ.QuantScheme(block), dtype=dt)
        d2 = JQ.dequantize(q2, s2, JQ.QuantScheme(block), dtype=dt)
        assert d1.dtype == d2.dtype
        np.testing.assert_array_equal(d1.view(np.uint8), d2.view(np.uint8))
    c = TQ.QuantChunk(q1, s1, TQ.QuantScheme(block))
    assert c.nbytes == TQ.QuantScheme(block).wire_bytes(x.size)
    np.testing.assert_array_equal(_u32(c.dequantize()),
                                  _u32(JQ.QuantChunk(q2, s2, JQ.QuantScheme(
                                      block)).dequantize()))


def test_dequantize_to_bfloat16_equals_ml_dtypes():
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    q, s = TQ.quantize(x, TQ.QuantScheme(256))
    got = TQ.dequantize(q, s, TQ.QuantScheme(256),
                        dtype=_lowp.LOWP["bfloat16"])
    want = JQ.dequantize(q, s, JQ.QuantScheme(256),
                         dtype=ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_schemes_and_wire_resolution_match_jax():
    for spec in ("int8_block256", "int8_block128", " int8_block4 ",
                 "bfloat16", "float16", None):
        t, j = TQ.parse_scheme(spec), JQ.parse_scheme(spec)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.block, t.name) == (j.block, j.name)
        assert TQ.wire_name(TQ.resolve_wire(spec)) == JQ.wire_name(
            JQ.resolve_wire(spec))
    assert TQ.parse_scheme("int8_block256") is TQ.QuantScheme(256)
    assert TQ.QuantScheme(256).scales_for(513) == 3
    with pytest.raises(ValueError, match=">= 1"):
        TQ.QuantScheme(0)
    with pytest.raises(ValueError, match="neither a quant scheme"):
        TQ.resolve_wire("int9_blocky")
    with pytest.raises(ValueError, match="scales"):
        TQ.dequantize(np.zeros(300, np.int8), np.zeros(1, np.float32),
                      TQ.QuantScheme(256))


def test_error_feedback_matches_jax():
    t, j = TQ.ErrorFeedback(), JQ.ErrorFeedback()
    for ef in (t, j):
        a = ef.residual_for("k", 5, np.float32)
        a[:] = [3, 4, 0, 0, 0]
        assert ef.residual_for("k", 5, np.float32) is a
        ef.residual_for(("bucket", 0), 2, np.float64)[:] = [12, 0]
    assert t.norm() == j.norm() == 13.0
    with pytest.raises(ValueError, match="different world size"):
        t.residual_for("k", 6, np.float32)
    assert repr(t) == repr(j)
