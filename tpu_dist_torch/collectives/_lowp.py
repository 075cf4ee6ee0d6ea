"""Low-precision floats (``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``)
as numpy arrays without ``ml_dtypes``.

The JAX package's host wire names these dtypes in its frame headers and
decodes them through ``ml_dtypes``.  The port keeps the names and the bit
patterns: a low-precision array is a numpy array of a one-field structured
dtype (``[("bfloat16", "<u2")]``), so slices, copies, ``frombuffer`` and
concatenation work as for any array, and the frame carries its raw 2- or
1-byte patterns under the JAX header name.  Arithmetic widens to float32
first (:func:`cast`), and narrowing rounds exactly as ``ml_dtypes``'
``astype`` does: to nearest even, float64 through float32 first, a NaN to
the quiet NaN of its sign, and a float8 overflow to NaN (``e4m3fn``) or
infinity (``e5m2``).  Tensors cross through torch dtype views
(:func:`from_torch`, :func:`to_torch`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["LOWP", "lowp_name", "is_lowp", "is_float", "dtype_name",
           "decode_dtype", "cast", "from_torch", "to_torch"]

_STORAGE = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e5m2": np.uint8}
LOWP: Dict[str, np.dtype] = {
    name: np.dtype([(name, np.dtype(st).newbyteorder("<"))])
    for name, st in _STORAGE.items()}
_TORCH = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}
_TORCH_VIEW = {np.dtype(np.uint16): torch.int16,
               np.dtype(np.uint8): torch.uint8}


def lowp_name(dt) -> Optional[str]:
    """The JAX name of a low-precision dtype, None for any other dtype."""
    try:
        dt = np.dtype(dt)
    except TypeError:
        return None
    names = dt.names
    if names and len(names) == 1 and LOWP.get(names[0]) == dt:
        return names[0]
    return None


def is_lowp(dt) -> bool:
    return lowp_name(dt) is not None


def is_float(dt) -> bool:
    """numpy floats and the low-precision floats (the JAX gates' "float":
    kind ``f`` or an ``ml_dtypes`` float)."""
    return np.dtype(dt).kind == "f" or is_lowp(dt)


def dtype_name(dt) -> str:
    """The wire header's dtype name (``"bfloat16"``, ``"float32"``, ...)."""
    return lowp_name(dt) or np.dtype(dt).name


def decode_dtype(name: str) -> np.dtype:
    """A wire header's dtype name as a numpy dtype (TypeError if unknown)."""
    got = LOWP.get(name)
    if got is not None:
        return got
    return np.dtype(name)


def _bits(a: np.ndarray, name: str) -> np.ndarray:
    return a.view(_STORAGE[name])


_f8_tables: Dict[str, np.ndarray] = {}


def _widen(a: np.ndarray, name: str) -> np.ndarray:
    """Low-precision -> float32, exact."""
    bits = _bits(a, name)
    if name == "bfloat16":
        return (bits.astype(np.uint32) << 16).view(np.float32)
    table = _f8_tables.get(name)
    if table is None:
        table = _f8_tables[name] = torch.arange(
            256, dtype=torch.int32).to(torch.uint8).view(
                _TORCH[name]).float().numpy()
    return table[bits]


def _narrow(x: np.ndarray, name: str) -> np.ndarray:
    """float32 -> low-precision, rounded as ``ml_dtypes`` rounds."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    sign = (u >> 31).astype(np.uint32)
    nan = np.isnan(x)
    if name == "bfloat16":
        with np.errstate(over="ignore"):
            r = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
                 >> 16).astype(np.uint16)
        r[nan] = (0x7FC0 | (sign[nan] << 15)).astype(np.uint16)
        return r.view(LOWP[name])
    r = torch.from_numpy(x.copy()).to(_TORCH[name]).view(
        torch.uint8).numpy().copy()
    ax = np.abs(x)
    s8 = (sign << 7).astype(np.uint8)
    if name == "float8_e4m3fn":
        bad = nan | (ax > np.float32(464.0))      # no infinity: NaN
        r[bad] = s8[bad] | np.uint8(0x7F)
    else:
        over = ~nan & (ax >= np.float32(61440.0))  # overflow: infinity
        r[over] = s8[over] | np.uint8(0x7C)
        r[nan] = s8[nan] | np.uint8(0x7E)
    return r.view(LOWP[name])


def cast(a, dt) -> np.ndarray:
    """``np.asarray(a).astype(dt)`` where either side may be low-precision."""
    a = np.asarray(a)
    dt = np.dtype(dt)
    src, dst = lowp_name(a.dtype), lowp_name(dt)
    if src is None and dst is None:
        return a.astype(dt)
    if src == dst:
        return a.copy()
    wide = _widen(a, src) if src is not None else a
    if dst is None:
        return wide.astype(dt)
    if wide.dtype != np.float32:
        with np.errstate(over="ignore"):   # ml_dtypes: float64 via float32
            wide = wide.astype(np.float32)
    return _narrow(wide, dst)


def from_torch(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: low-precision tensors as their bit patterns under
    the low-precision dtype.  A CPU tensor's array shares its memory."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    for name, tdt in _TORCH.items():
        if t.dtype == tdt:
            st = np.dtype(_STORAGE[name])
            return t.view(_TORCH_VIEW[st]).numpy().view(st).view(LOWP[name])
    return t.numpy()


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """Inverse of :func:`from_torch` (a copy on ``device`` when given)."""
    a = np.asarray(a)
    name = lowp_name(a.dtype)
    if name is not None:
        st = np.dtype(_STORAGE[name])
        t = torch.from_numpy(np.ascontiguousarray(a).view(st).view(
            np.int16 if st.itemsize == 2 else np.uint8)).view(_TORCH[name])
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t if device is None else t.to(device)
