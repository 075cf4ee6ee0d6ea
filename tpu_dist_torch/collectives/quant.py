"""Block-quantized int8 wire format for the host ring collectives, with
error feedback — the port's copy of ``tpu_dist/collectives/quant.py``.

A :class:`QuantScheme` (spec ``"int8_block{N}"``, e.g. ``"int8_block256"``)
compresses each ring sub-chunk to an int8 payload and one float32 scale per
N-element block (about 3.9x fewer wire bytes than float32 at block 256).
Quantization is symmetric per block: ``scale = max|x| / 127``, ``q =
clip(rint(x / scale), -127, 127)``; dequantization is ``q * scale``.  A zero
or underflowing block (``1/scale`` overflows) gets scale 0 and a zero
payload; a block holding inf or NaN gets scale NaN and dequantizes to NaN.
Every function is the JAX module's numpy arithmetic, so both packages put
the same bytes on the wire and a JAX rank and a port rank share one ring.

:class:`ErrorFeedback` keeps the residuals a lossy wire drops: the
Bucketer's all-reduce keeps a full (hop and owner) residual per bucket, its
reduce-scatter and ``ZeroOptimizer(error_feedback=True)`` the owner
residual, shard-shaped (``zstate["ef"]``).  See the JAX module's docstring
for the byte-identity argument (the all-gather forwards the owner's
``(q, scales)`` frames verbatim).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from . import _lowp

__all__ = ["QuantScheme", "QuantChunk", "ErrorFeedback", "parse_scheme",
           "resolve_wire", "wire_name", "quantize", "dequantize"]

_SPEC_RE = re.compile(r"^int8_block(\d+)$")


class QuantScheme:
    """One block-quantized wire format: int8 payload, float32 scale per
    ``block`` contiguous elements.  Instances are interned per block size
    so scheme comparison is identity-cheap."""

    __slots__ = ("block", "name")
    _interned: Dict[int, "QuantScheme"] = {}

    def __new__(cls, block: int):
        block = int(block)
        if block < 1:
            raise ValueError(f"quant block size must be >= 1, got {block}")
        got = cls._interned.get(block)
        if got is None:
            got = cls._interned[block] = object.__new__(cls)
            got.block = block
            got.name = f"int8_block{block}"
        return got

    def scales_for(self, n: int) -> int:
        """Number of per-block scales covering ``n`` elements."""
        return -(-int(n) // self.block)

    def wire_bytes(self, n: int) -> int:
        """Total wire payload bytes for ``n`` elements (q + scales)."""
        return int(n) + 4 * self.scales_for(n)

    def __repr__(self):
        return f"QuantScheme({self.name!r})"


def parse_scheme(spec) -> Optional[QuantScheme]:
    """``"int8_block256"`` -> :class:`QuantScheme`; None when ``spec`` is
    not a quant-scheme string (a plain dtype name, or None)."""
    if isinstance(spec, QuantScheme):
        return spec
    if not isinstance(spec, str):
        return None
    m = _SPEC_RE.match(spec.strip())
    return QuantScheme(int(m.group(1))) if m else None


def resolve_wire(spec):
    """THE parser for everything ``comm_dtype`` accepts: None (no
    compression), a :class:`QuantScheme` / ``"int8_blockN"`` spec, or any
    dtype the wire header can name (``"bfloat16"``, ``np.float16``, ...).
    Every rank parses the same launcher-level spec, so the wire decision
    stays rank-consistent."""
    if spec is None:
        return None
    scheme = parse_scheme(spec)
    if scheme is not None:
        return scheme
    try:
        if isinstance(spec, str):
            return _lowp.decode_dtype(spec)
        return np.dtype(spec)
    except Exception as e:
        raise ValueError(
            f"comm_dtype spec {spec!r} is neither a quant scheme "
            f"(int8_block{{N}}, e.g. int8_block256) nor a wire-decodable "
            f"dtype name (e.g. bfloat16): {e!r}") from e


def wire_name(wire) -> Optional[str]:
    """Canonical spec string for a resolved wire (None / dtype / scheme) —
    what the sanitizer signs and obs spans carry."""
    if wire is None:
        return None
    if isinstance(wire, QuantScheme):
        return wire.name
    return _lowp.dtype_name(wire)


def quantize(x, scheme: QuantScheme) -> Tuple[np.ndarray, np.ndarray]:
    """Block-quantize a flat float array; returns ``(q int8[n],
    scales float32[ceil(n/block)])``.  Deterministic (pure vectorized
    numpy), so identical inputs produce identical bytes on every rank."""
    x = np.asarray(x)
    if _lowp.is_lowp(x.dtype):
        x = _lowp.cast(x, np.float32)
    xf = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    n = xf.size
    b = scheme.block
    nb = scheme.scales_for(n)
    if n == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.float32)
    if nb * b != n:
        padded = np.zeros(nb * b, np.float32)
        padded[:n] = xf
        xb = padded.reshape(nb, b)
    else:
        xb = xf.reshape(nb, b)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        amax = np.max(np.abs(xb), axis=1)
        finite = np.isfinite(amax)
        scales = np.where(finite, amax / np.float32(127.0),
                          np.float32(np.nan)).astype(np.float32)
        inv = np.where(finite & (scales > 0),
                       np.float32(1.0) / scales, np.float32(0.0))
        # 1/scale may overflow for deeply subnormal amax: such a block is
        # numerically zero at int8 resolution — emit exact zeros (scale 0)
        bad = ~np.isfinite(inv)
        if bad.any():
            inv[bad] = 0.0
            scales[bad & finite] = 0.0
        scaled = xb * inv[:, None]
        np.rint(scaled, out=scaled)
        np.clip(scaled, -127.0, 127.0, out=scaled)
    if not finite.all():
        scaled[~finite] = 0.0  # poisoned blocks: zero payload, NaN scale
    return scaled.astype(np.int8).reshape(-1)[:n], scales


def dequantize(q, scales, scheme: QuantScheme,
               dtype=np.float32) -> np.ndarray:
    """Invert :func:`quantize`: ``q * scales`` per block, returned flat in
    ``dtype``."""
    q = np.asarray(q).reshape(-1)
    n = q.size
    if n == 0:
        return np.zeros(0, dtype)
    b = scheme.block
    nb = scheme.scales_for(n)
    scales = np.asarray(scales, np.float32).reshape(-1)
    if scales.size != nb:
        raise ValueError(
            f"quant frame mismatch: {n} elements at block {b} need {nb} "
            f"scales, got {scales.size}")
    if nb * b != n:
        padded = np.zeros(nb * b, np.int8)
        padded[:n] = q
        qb = padded.reshape(nb, b)
    else:
        qb = q.reshape(nb, b)
    out = (qb.astype(np.float32) * scales[:, None]).reshape(-1)[:n]
    if _lowp.is_lowp(dtype):
        return _lowp.cast(out, dtype)
    return out.astype(dtype, copy=False)


class QuantChunk:
    """One quantized wire frame as received: int8 payload + per-block
    scales.  The transport's reader thread hands these to the ring, which
    dequantizes at the fold (reduce-scatter) or forwards the frame
    verbatim (all-gather) — see the module docstring's byte-identity
    argument."""

    __slots__ = ("q", "scales", "scheme")

    def __init__(self, q: np.ndarray, scales: np.ndarray,
                 scheme: QuantScheme):
        self.q = q
        self.scales = scales
        self.scheme = scheme

    @property
    def size(self) -> int:
        return self.q.size

    @property
    def nbytes(self) -> int:
        """Wire payload bytes this frame occupied."""
        return self.q.nbytes + self.scales.nbytes

    def dequantize(self, dtype=np.float32) -> np.ndarray:
        return dequantize(self.q, self.scales, self.scheme, dtype=dtype)

    def __repr__(self):
        return (f"QuantChunk(n={self.q.size}, "
                f"scheme={self.scheme.name!r})")


class ErrorFeedback:
    """Error-feedback residual state for lossy wire formats.

    A plain keyed store of residual arrays (see the module docstring for
    the semantics each consumer attaches): the bucketed **all-reduce**
    keeps one full-bucket-layout residual per bucket (hop + owner errors),
    the bucketed **reduce-scatter** one owned-chunk residual per leaf.
    Pass the same object every step — the residual IS the cross-step
    state.  ``ZeroOptimizer`` builds one per step whose arrays are views
    into the checkpointed ``zstate["ef"]`` shards, so the residual rides
    the ZeRO shard layout and the elastic reshard manifest for free.
    """

    __slots__ = ("residuals",)

    def __init__(self):
        self.residuals: Dict = {}

    def residual_for(self, key, length: int, dtype) -> np.ndarray:
        """The residual array under ``key`` (created as zeros on first
        use); raises when a held residual no longer matches ``length`` —
        a world-size or tree-structure change means the residual belongs
        to a different layout and must not be folded into this one."""
        got = self.residuals.get(key)
        if got is None:
            got = self.residuals[key] = np.zeros(length, np.dtype(dtype))
        elif got.size != length:
            raise ValueError(
                f"error-feedback residual {key!r} has {got.size} "
                f"elements, this collective needs {length}: the residual "
                f"was built at a different world size / tree structure "
                f"(reset ErrorFeedback after elastic changes)")
        return got

    def norm(self) -> float:
        """Global L2 norm of the held residuals (diagnostics: how much
        gradient mass error feedback is carrying step to step)."""
        total = 0.0
        for a in self.residuals.values():
            af = np.asarray(a, np.float64)
            total += float(np.dot(af, af))
        return float(np.sqrt(total))

    def __repr__(self):
        return f"ErrorFeedback({len(self.residuals)} leaves)"
