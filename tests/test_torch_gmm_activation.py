"""The port's ``gmm(activation=...)`` (B2) against the JAX package's
``tpu_dist/ops/gmm.py`` ``gmm(activation=...)``.

The JAX side runs its Pallas kernel in interpret mode on the CPU, where the
activation is applied to the float32 accumulator inside the kernel body; the
port's wrapper takes its plain version on CPU tensors.  Same numpy inputs on
both sides (weights scaled by 1/sqrt(D), so the sums fall in the curved part
of every activation): a sorted, block-aligned layout of ragged groups with
zero padding rows, one group with no rows, a bias, and two dead tail blocks,
at block_rows 8; in float32, in bf16, and bf16 in with float32 out.  The
whole output is compared, dead rows included: both sides write exact zeros
there, never ``activation(0)`` (sigmoid(0) = 0.5).

Tolerances: float32 out, 1e-5 relative plus 1e-6 of the output's rms (the
same sums in another order); bf16 out, one bf16 step (2^-7 relative) plus
the same rms floor, for an element whose float32 value lies near a rounding
boundary or near 0.  Both add 4 float32 ulps of the element's pre-activation
value a (2^-21 |a|): XLA's and torch's float32 erf, tanh and exp on the CPU
are approximations a few ulps from exact, and the GELU forms' 1 + erf(.) and
1 + tanh(.) cancel for a below about -3, where that error shows at the scale
of a rather than of the output (torch's exact GELU at a = -3.44 is 7.2e-7
from the float64 value of -1.0e-3; XLA's 1.6e-7 at worst).  A wrong
function is off by 1e-4 (erf against tanh GELU at a = 1) or more."""

import functools
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_dist_torch.ops import KERNELS

# the modules, not the same-named functions their packages re-export
jgmm = importlib.import_module("tpu_dist.ops.gmm")
tgmm_mod = importlib.import_module("tpu_dist_torch.ops.gmm")

B = 8                          # block_rows
E = 4
BLOCKS = (2, 0, 1, 3)          # group 1 has no rows
D, H = 16, 24
RMS_FLOOR = 1e-6
PRE_ULPS = 2.0 ** -21          # 4 float32 ulps of 1, times |a|
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# name -> (the JAX package's callable, the port's)
PAIRS = {
    "gelu_tanh": (jax.nn.gelu, tgmm_mod.gelu_tanh),
    "gelu": (functools.partial(jax.nn.gelu, approximate=False), F.gelu),
    "relu": (jax.nn.relu, F.relu),
    "silu": (jax.nn.silu, F.silu),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "tanh": (jnp.tanh, torch.tanh),
    # any callable on the CPU, as in the JAX package (no kernel epilogue)
    "custom": (lambda v: v * jax.nn.sigmoid(1.702 * v),
               lambda v: v * torch.sigmoid(1.702 * v)),
}
# (input dtype, out_dtype or None)
DTYPES = {"float32": ("float32", None), "bfloat16": ("bfloat16", None),
          "bf16_to_f32": ("bfloat16", "float32")}


def _case(seed=0):
    """x (M, D) sorted by group with zero padding rows, w (E, D, H) scaled
    to unit-variance sums, bias (E, H), the block map and the live count."""
    rng = np.random.default_rng(seed)
    nb_live = sum(BLOCKS)
    nb = nb_live + 2
    x = np.zeros((nb * B, D), np.float32)
    bg, r = [], 0
    for g, nblk in enumerate(BLOCKS):
        n_rows = max(nblk * B - B // 2, 0)
        x[r:r + n_rows] = rng.standard_normal((n_rows, D))
        bg += [g] * nblk
        r += nblk * B
    bg += [E - 1] * (nb - nb_live)
    w = (rng.standard_normal((E, D, H)) / np.sqrt(D)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((E, H))).astype(np.float32)
    return dict(x=x, w=w, bias=bias, bg=np.asarray(bg, np.int32),
                n_live=nb_live)


@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(PAIRS))
def test_gmm_activation_matches_jax(act, dtypes):
    c = _case()
    j_act, t_act = PAIRS[act]
    in_name, out_name = DTYPES[dtypes]
    j_in = getattr(jnp, in_name)
    t_in = getattr(torch, in_name)
    want = np.asarray(jgmm.gmm(
        jnp.asarray(c["x"], j_in), jnp.asarray(c["w"], j_in),
        jnp.asarray(c["bg"]), jnp.int32(c["n_live"]),
        bias=jnp.asarray(c["bias"], j_in), block_rows=B,
        out_dtype=getattr(jnp, out_name) if out_name else None,
        activation=j_act).astype(jnp.float32))
    args = (torch.from_numpy(c["x"]).to(t_in),
            torch.from_numpy(c["w"]).to(t_in), torch.from_numpy(c["bg"]),
            c["n_live"])
    kw = dict(bias=torch.from_numpy(c["bias"]).to(t_in), block_rows=B)
    out_dtype = getattr(torch, out_name) if out_name else None
    got = tgmm_mod.gmm(*args, **kw, out_dtype=out_dtype, activation=t_act)
    pre = tgmm_mod.gmm_plain(*args, **kw, out_dtype=torch.float32).numpy()
    assert got.dtype == getattr(torch, out_name or in_name)
    assert got.shape == want.shape == (c["x"].shape[0], H)
    got = got.float().numpy()
    # the dead tail is exact zeros on both sides, whatever act(0) is
    dead = c["n_live"] * B
    assert not got[dead:].any() and not want[dead:].any()
    limit = (RTOL[out_name or in_name] * np.abs(want) + PRE_ULPS * np.abs(pre)
             + RMS_FLOOR * float(np.sqrt(np.mean(want ** 2))))
    worst = np.unravel_index(np.argmax(np.abs(got - want) - limit),
                             want.shape)
    assert (np.abs(got - want) <= limit).all(), (
        f"{act}/{dtypes}: at {worst} got {got[worst]}, JAX {want[worst]}, "
        f"limit {limit[worst]}, pre-activation {pre[worst]}")


@pytest.mark.parametrize("name", sorted(tgmm_mod.ACTIVATIONS))
def test_each_known_callable_maps_to_its_epilogue(name):
    """Every callable of an activation (``F.relu`` and ``torch.relu``
    alike) gives that activation's name, the one the parity test passes
    among them."""
    fns = tgmm_mod._ACTIVATION_FNS[name]
    assert fns
    for fn in fns.values():
        assert tgmm_mod.activation_name(fn) == name
    assert tgmm_mod.activation_name(PAIRS[name][1]) == name


def test_activation_codes_match_the_kernel_enum():
    """ACTIVATIONS' codes are csrc/gmm.cu's ``enum Act`` (a source scan: no
    nvcc), 0 left for none."""
    src = (Path(tgmm_mod.__file__).resolve().parent.parent / "csrc"
           / "gmm.cu").read_text()
    body = re.search(r"enum Act \{([^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in body.split(",")]
    assert names[0] == "kActNone" and names[-1] == "kNumActs"
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).lower()
             for n in names[1:-1]]
    assert {n: i + 1 for i, n in enumerate(snake)} == tgmm_mod.ACTIVATIONS
    assert set(tgmm_mod._ACTIVATION_FNS) == set(tgmm_mod.ACTIVATIONS)


@pytest.mark.parametrize("fn", [
    lambda v: v,
    functools.partial(F.gelu, approximate="tanh"),   # torch's tanh GELU
    jax.nn.gelu,                                     # the JAX callable
], ids=["lambda", "partial_gelu_tanh", "jax_gelu"])
def test_unknown_activation_raises_off_the_cpu(fn):
    """A callable with no kernel epilogue raises ValueError naming it and
    the known set, before any launch; a tensor off the CPU (here on the
    meta device, so no card is needed) never takes the plain version."""
    with pytest.raises(ValueError, match="no epilogue") as info:
        tgmm_mod.activation_name(fn)
    assert "gelu_tanh" in str(info.value) and repr(fn) in str(info.value)
    c = _case()
    before = [k.launches for k in KERNELS]
    with pytest.raises(ValueError, match="no epilogue"):
        tgmm_mod.gmm(torch.from_numpy(c["x"]).to("meta"),
                     torch.from_numpy(c["w"]).to("meta"),
                     torch.from_numpy(c["bg"]).to("meta"), c["n_live"],
                     block_rows=B, activation=fn)
    assert [k.launches for k in KERNELS] == before
    assert not any(tgmm_mod.gmm.launches_by_activation.values())
