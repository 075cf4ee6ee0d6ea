"""The port's grouped matmuls (``tpu_dist_torch.ops.gmm``) against the JAX
package's ``tpu_dist/ops/gmm.py``.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port's
wrappers take their plain versions on CPU tensors.  Same numpy inputs on both
sides: a sorted, block-aligned layout of ragged groups (half-block padding
rows of zeros), one group with no rows, and two dead tail blocks carrying the
last group's id, at block_rows 8.  Both D <= H and D > H, which take the two
branches of the grouped-linear backward.

Tolerance: float32 throughout, the same terms summed in another order —
1e-5 relative plus 1e-5 absolute (outputs are O(1)-O(10))."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_torch.ops import KERNELS

# the modules, not the same-named functions their packages re-export
jgmm = importlib.import_module("tpu_dist.ops.gmm")
tgmm_mod = importlib.import_module("tpu_dist_torch.ops.gmm")

B = 8                        # block_rows
E = 4
BLOCKS = (2, 0, 1, 3)        # group 1 has no rows
RTOL, ATOL = 1e-5, 1e-5
SHAPES = {"d_le_h": (16, 24), "d_gt_h": (24, 16)}


def _case(d, h, seed=0):
    """x (M, d) sorted by group with zero padding rows, w (E, d, h), bias,
    dy (M, h) (zero on padding rows, as the MoE backward gives), the block
    map, the live count and each row's group (-1 = padding)."""
    rng = np.random.default_rng(seed)
    nb_live = sum(BLOCKS)
    nb = nb_live + 2
    m = nb * B
    x = np.zeros((m, d), np.float32)
    dy = np.zeros((m, h), np.float32)
    row_group = np.full(m, -1)
    bg, r = [], 0
    for g, nblk in enumerate(BLOCKS):
        n_rows = max(nblk * B - B // 2, 0)
        x[r:r + n_rows] = rng.standard_normal((n_rows, d))
        dy[r:r + n_rows] = rng.standard_normal((n_rows, h))
        row_group[r:r + n_rows] = g
        bg += [g] * nblk
        r += nblk * B
    bg += [E - 1] * (nb - nb_live)
    w = rng.standard_normal((E, d, h)).astype(np.float32)
    bias = rng.standard_normal((E, h)).astype(np.float32)
    return dict(x=x, dy=dy, w=w, bias=bias, bg=np.asarray(bg, np.int32),
                n_live=nb_live, row_group=row_group)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's gmm / tgmm / grouped_linear on each case."""
    out = {}
    for name, (d, h) in SHAPES.items():
        c = _case(d, h)
        x, dy, w, bias = (jnp.asarray(c[k]) for k in ("x", "dy", "w", "bias"))
        bg, n_live = jnp.asarray(c["bg"]), jnp.int32(c["n_live"])
        present = jnp.asarray([n > 0 for n in BLOCKS])
        ref = {"gmm": jgmm.gmm(x, w, bg, n_live, bias=bias, block_rows=B),
               "gmm_wt": jgmm.gmm(dy, jnp.swapaxes(w, 1, 2), bg, n_live,
                                  block_rows=B),
               "tgmm": jgmm.tgmm(x, dy, bg, E, block_rows=B,
                                 with_rowsum=True)}

        def objective(x, w, bias):
            y = jgmm.grouped_linear(x, w, bias, bg, n_live, present, B, 512)
            return jnp.sum(y * dy)

        ref["grads"] = jax.grad(objective, argnums=(0, 1, 2))(x, w, bias)
        out[name] = (c, jax.tree.map(np.asarray, ref))
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gmm_plain_matches_jax(jax_ref, shape):
    c, ref = jax_ref[shape]
    got = tgmm_mod.gmm(_t(c["x"]), _t(c["w"]), _t(c["bg"]), c["n_live"],
                       bias=_t(c["bias"]), block_rows=B)
    np.testing.assert_allclose(got.numpy(), ref["gmm"], rtol=RTOL, atol=ATOL)
    # dead tail blocks are zeros, padding rows of live blocks carry the bias
    assert not got[c["n_live"] * B:].any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gmm_reads_transposed_weights(jax_ref, shape):
    """The dx form: w given as the transpose view of a contiguous tensor."""
    c, ref = jax_ref[shape]
    wt = _t(c["w"]).transpose(1, 2)
    assert not wt.is_contiguous()
    got = tgmm_mod.gmm(_t(c["dy"]), wt, _t(c["bg"]), c["n_live"],
                       block_rows=B)
    np.testing.assert_allclose(got.numpy(), ref["gmm_wt"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tgmm_plain_matches_jax(jax_ref, shape):
    c, ref = jax_ref[shape]
    dw_j, db_j = ref["tgmm"]
    present = np.asarray([n > 0 for n in BLOCKS])
    for n_live in (None, c["n_live"]):  # the tail rows are zero: no change
        dw, db = tgmm_mod.tgmm(_t(c["x"]), _t(c["dy"]), _t(c["bg"]), E,
                               block_rows=B, with_rowsum=True,
                               n_live_blocks=n_live)
        # the JAX kernel leaves an absent group unwritten; the port writes 0
        np.testing.assert_allclose(dw.numpy()[present], dw_j[present],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(db.numpy()[present], db_j[present],
                                   rtol=RTOL, atol=ATOL)
        assert not dw[~torch.from_numpy(present)].any()
        assert not db[~torch.from_numpy(present)].any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_grouped_linear_grads_match_jax(jax_ref, shape):
    c, ref = jax_ref[shape]
    x = _t(c["x"]).requires_grad_(True)
    w = _t(c["w"]).requires_grad_(True)
    bias = _t(c["bias"]).requires_grad_(True)
    y = tgmm_mod.grouped_linear(x, w, bias, _t(c["bg"]), c["n_live"], B)
    (y * _t(c["dy"])).sum().backward()
    for got, want, name in zip((x.grad, w.grad, bias.grad), ref["grads"],
                               ("dx", "dw", "db")):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert not w.grad[1].any() and not bias.grad[1].any()  # absent group


def test_group_offsets_match_the_block_map():
    """The row range tgmm's kernel loops over for each group, computed on
    the device from the sorted block map, with and without the live
    count."""
    c = _case(8, 8)
    bg = _t(c["bg"])
    starts = np.cumsum((0,) + BLOCKS) * B
    np.testing.assert_array_equal(
        tgmm_mod.group_offsets(bg, E, B, c["n_live"]).numpy(), starts)
    # without n_live the dead tail extends the last group
    want = starts.copy()
    want[-1] = len(c["bg"]) * B
    off = tgmm_mod.group_offsets(bg, E, B)
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), want)


def test_cpu_tensors_take_the_plain_versions():
    """On a CPU tensor the wrappers compute the plain version and count no
    launch; gmm_impl('plain') selects the plain pair explicitly."""
    c = _case(16, 24, seed=1)
    before = [k.launches for k in KERNELS]
    args = (_t(c["x"]), _t(c["w"]), _t(c["bg"]), c["n_live"])
    torch.testing.assert_close(
        tgmm_mod.gmm(*args, bias=_t(c["bias"]), block_rows=B),
        tgmm_mod.gmm_plain(*args, bias=_t(c["bias"]), block_rows=B))
    x = _t(c["x"]).requires_grad_(True)
    with tgmm_mod.gmm_impl("plain"):
        y = tgmm_mod.grouped_linear(x, _t(c["w"]), None, _t(c["bg"]),
                                    c["n_live"], B)
    y.sum().backward()
    assert [k.launches for k in KERNELS] == before
    with pytest.raises(ValueError, match="kernel"):
        with tgmm_mod.gmm_impl("fast"):
            pass


def test_gmm_refuses_what_it_does_not_take():
    c = _case(16, 24)
    x, w, bg = _t(c["x"]), _t(c["w"]), _t(c["bg"])
    with pytest.raises(NotImplementedError, match="activation"):
        tgmm_mod.gmm(x, w, bg, c["n_live"], block_rows=B,
                     activation=torch.tanh)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgmm_mod.gmm(x[:-12], w, bg[:-1], c["n_live"], block_rows=12)
    with pytest.raises(ValueError, match="not a multiple"):
        tgmm_mod.gmm(x[:-1], w, bg, c["n_live"], block_rows=B)
    with pytest.raises(ValueError, match="contraction"):
        tgmm_mod.gmm(x, w.transpose(1, 2), bg, c["n_live"], block_rows=B)
    with pytest.raises(ValueError, match="rows"):
        tgmm_mod.tgmm(x, _t(c["dy"])[:-B], bg, E, block_rows=B)


# (dtype, block_rows, D, H, 16-byte aligned bases) -> the kernel design a CUDA
# call takes (None: refused): the path's shapes and a small wgmma case, the
# ragged shapes, a row block shorter than the 128-row tile, widths off the
# 64-wide TMA box, a misaligned bf16 base (no bf16 design takes it), and
# float32 (its FMA kernels take any base)
DESIGN_CASES = {
    "w1_fwd_and_tgmm": (torch.bfloat16, 512, 768, 3072, True, "wgmma"),
    "w2_fwd_and_dx_of_w1": (torch.bfloat16, 512, 3072, 768, True, "wgmma"),
    "small_wgmma": (torch.bfloat16, 128, 256, 640, True, "wgmma"),
    "ragged_8": (torch.bfloat16, 8, 200, 360, True, "mma_sync"),
    "ragged_24": (torch.bfloat16, 24, 200, 360, True, "mma_sync"),
    "rows_64": (torch.bfloat16, 64, 768, 3072, True, "mma_sync"),
    "rows_192": (torch.bfloat16, 192, 768, 3072, True, "mma_sync"),
    "d_off_box": (torch.bfloat16, 512, 200, 3072, True, "mma_sync"),
    "h_off_box": (torch.bfloat16, 512, 768, 360, True, "mma_sync"),
    "misaligned_base": (torch.bfloat16, 512, 768, 3072, False, None),
    "float32_misaligned": (torch.float32, 512, 768, 3072, False, "fma"),
    "float32_path_shapes": (torch.float32, 512, 768, 3072, True, "fma"),
    "float32_ragged": (torch.float32, 8, 200, 360, True, "fma"),
}


@pytest.mark.parametrize("case", sorted(DESIGN_CASES))
def test_gmm_design_rule(case):
    dtype, block_rows, d, h, aligned, want = DESIGN_CASES[case]
    if want is None:
        with pytest.raises(ValueError, match="aligned"):
            tgmm_mod.gmm_design(dtype, block_rows, d, h, aligned)
        return
    assert tgmm_mod.gmm_design(dtype, block_rows, d, h, aligned) == want
    assert want in tgmm_mod.DESIGNS


def test_forced_design_fits_the_shapes():
    """The same-call comparison (``_older=True``) runs the older design on a
    shape that takes wgmma and is refused on any other; a misaligned base
    is seen from the tensors themselves."""
    x = torch.zeros(1024, 768, dtype=torch.bfloat16)
    pick = tgmm_mod._pick_design
    assert pick(False, x.dtype, 512, 768, 3072, x) == "wgmma"
    assert pick(True, x.dtype, 512, 768, 3072, x) == "mma_sync"
    assert pick(False, x.dtype, 8, 200, 360, x) == "mma_sync"
    with pytest.raises(ValueError, match="_older"):
        pick(True, x.dtype, 8, 200, 360, x)
    with pytest.raises(ValueError, match="_older"):
        pick(True, torch.float32, 512, 768, 3072, x.float())
    shifted = x.view(-1)[1:1 + 512 * 768].view(512, 768)
    with pytest.raises(ValueError, match="aligned"):
        pick(False, x.dtype, 512, 768, 3072, shifted)


def _c_exports(source):
    """Name -> parameter count of every function defined in the source's
    ``extern "C"`` block."""
    import re
    block = source[source.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)\s*\{", block,
                         re.M):
        out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


def test_c_entry_points_match_the_signatures():
    """Every entry point the wrapper binds is exported by csrc/gmm.cu with
    as many parameters as its ctypes signature (a source scan: no nvcc)."""
    from pathlib import Path
    src = (Path(tgmm_mod.__file__).resolve().parent.parent / "csrc"
           / "gmm.cu").read_text()
    exports = _c_exports(src)
    for name, argtypes in tgmm_mod._SIGNATURES.items():
        assert name in exports, name
        assert exports[name] == len(argtypes), name
    assert exports["gmm_error_string"] == 1
