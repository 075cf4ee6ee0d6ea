"""B2, ``gmm(activation=)``, on the card at the MoE up-projection shape, and
K3/K4 of this checkout against another checkout's.

At the dropless MoE layer's shape (16384 tokens routed top-2 of 8 by a
random router, block rows 512, x (M, 768) bf16 with its dead tail, w (8,
768, 3072), bias) it times, for each activation the kernels know, B2 beside
K3 alone and beside the two-call composition ``torch._grouped_mm`` + the
activation (no bias: ``_grouped_mm`` takes none, so B2 is timed without it
there too), the bound, and each kernel held to its plain version.  Times
are CUDA events around 10 back-to-back launches, per launch (the card's
time: the host enqueues ahead), median of 10 samples, taken in turns.

With ``--other DIR`` (another checkout, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory), that tree's
``tpu_dist_torch/ops`` is loaded beside this one under another name, built
from its own sources, and K3 without an activation and K4 with the row sum
of both trees are timed in turns (other, this, this, other) and compared
bit for bit; the ``ptxas -v`` lines of both builds' gmm kernels are
printed, and whether each wgmma kernel the two share (K3 without an
activation, K4) has the same instructions (``cuobjdump -sass``).  One JSON line; the card's name and power limit in it.

    python -m tpu_dist_torch.benchmarks.gmm_activation [--other DIR]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ._card import device_stamp
from .flash_kernels import margin, time_ms

# chip_smoke.py's bf16 limits for the grouped kernels: rtol, atol, of the
# row's rms, of the tensor's rms
_BF16_TOL = (8e-3, 0.0, 0.0, 1e-5)
_BATCH = 10


def path_case(device, seed: int = 7) -> dict:
    """The dropless layer's layout at the path shape: rows sorted by expert
    into 512-row segments (padding rows zero), ceil(kN/512) + E blocks with
    the dead tail on the last expert."""
    g = torch.Generator(device=device).manual_seed(seed)
    e, b, d, h = 8, 512, 768, 3072
    probs = torch.randn(16384, e, device=device, generator=g).softmax(-1)
    counts = torch.bincount(probs.topk(2, dim=-1).indices.reshape(-1),
                            minlength=e).tolist()
    nb = -(-sum(counts) // b) + e
    mask = torch.zeros(nb * b, 1, dtype=torch.bool, device=device)
    bg, ends, start = [], [], 0
    for i, c in enumerate(counts):
        mask[start:start + c] = True
        bg += [i] * -(-c // b)
        start += -(-c // b) * b
        ends.append(start)
    n_live = len(bg)
    bg += [e - 1] * (nb - n_live)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=device, generator=g) * scale
                ).to(torch.bfloat16)

    return dict(x=(rand(nb * b, d).float() * mask).to(torch.bfloat16),
                dy=(rand(nb * b, h).float() * mask).to(torch.bfloat16),
                w=rand(e, d, h, scale=d ** -0.5), bias=rand(e, h),
                bg=torch.tensor(bg, dtype=torch.int32, device=device),
                n_live=torch.tensor([n_live], dtype=torch.int32,
                                    device=device),
                ends=torch.tensor(ends, dtype=torch.int32, device=device),
                routed=sum(counts), block_rows=b)


def per_launch_ms(fn) -> float:
    """Card time a launch: ``_BATCH`` back-to-back calls a sample."""
    def batch():
        for _ in range(_BATCH):
            fn()
    return time_ms(batch) / _BATCH


def load_ops(tree: Path, name: str):
    """``tree``'s ``tpu_dist_torch/ops`` package, imported as ``name`` (its
    kernels built from that tree's sources into its own build directory)."""
    pkg = Path(tree).resolve() / "tpu_dist_torch" / "ops"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(build, lib: str = "gmm") -> dict:
    """Kernel (mangled name) -> its ``ptxas -v`` register and spill lines
    and the codes of the advisories about it (C7517: a wgmma wait the
    compiler injected; C7518: wgmma serialized), for the gmm and tgmm
    kernels of the library's last build."""
    out, entry = {}, None
    for line in build.compile_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        advisory = re.search(r"\((C75\d\d)\).*function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif advisory and "gmm" in advisory.group(2):
            out.setdefault(advisory.group(2), []).append(advisory.group(1))
        elif entry and "gmm" in entry and ("registers" in line
                                           or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def run(other=None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("gmm_activation times the card; it needs one")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")
    c = path_case(dev)
    x, w, bias, bg, n_live = (c[k] for k in ("x", "w", "bias", "bg",
                                              "n_live"))
    b, live = c["block_rows"], int(c["n_live"]) * c["block_rows"]
    e, d, h = w.shape
    acts = {"gelu_tanh": gm.gelu_tanh, "gelu": F.gelu, "relu": F.relu,
            "silu": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}

    def k3(bb=bias):
        return gm.gmm(x, w, bg, n_live, bias=bb, block_rows=b)

    result = {**device_stamp(dev), "shape": {
        "x": list(x.shape), "w": list(w.shape), "block_rows": b,
        "routed_rows": c["routed"], "live_rows": live}}
    # bound: x's routed rows, w and the bias read once, the output written;
    # the routed rows' products on the tensor cores (the activation's ~9
    # float32 operations an output run beside them, on the CUDA cores)
    bytes_moved = (c["routed"] * d + e * d * h + e * h + x.shape[0] * h) * 2
    flop = 2 * c["routed"] * d * h
    result["bound_ms"] = max(bytes_moved / 3.35e12, flop / 989e12,
                             live * h * 9 / 67e12) * 1e3
    grouped = (lambda: torch._grouped_mm(x[:live], w, offs=c["ends"]))
    rows = {}
    for name, fn in acts.items():
        def b2(bb=bias, fn=fn):
            return gm.gmm(x, w, bg, n_live, bias=bb, block_rows=b,
                          activation=fn)

        def composed(fn=fn):
            return fn(grouped())

        err = margin(b2(), gm.gmm_plain(x, w, bg, n_live, bias=bias,
                                        block_rows=b, activation=fn),
                     *_BF16_TOL)
        t_b2, t_k3 = per_launch_ms(b2), per_launch_ms(k3)
        t_k3 = (t_k3 + per_launch_ms(k3)) / 2
        t_b2 = (t_b2 + per_launch_ms(b2)) / 2
        rows[name] = {"b2_ms": t_b2, "k3_ms": t_k3, "b2_over_k3": t_b2 / t_k3,
                      "b2_no_bias_ms": per_launch_ms(lambda: b2(None)),
                      "composition_ms": per_launch_ms(composed),
                      "margin": err, "ok": err <= 1.0}
    result["activations"] = rows
    result["plain_ms_gelu_tanh"] = time_ms(lambda: gm.gmm_plain(
        x, w, bg, n_live, bias=bias, block_rows=b,
        activation=gm.gelu_tanh), reps=3)
    result["ptxas"] = ptxas_lines(gm._build)
    if other is not None:
        result["other"] = _against(load_ops(Path(other), "_other_ops"), gm,
                                   c)
    result["ok"] = all(r["ok"] for r in rows.values()) and all(
        result.get("other", {}).get("bitwise", {True: True}).values())
    return result


def _against(other_ops, gm, c) -> dict:
    """K3 without an activation and K4 with the row sum, this tree's against
    ``other_ops``' (another checkout's), in turns, and bit for bit; B2 with
    each activation too where the other tree has it."""
    og = sys.modules[f"{other_ops.__name__}.gmm"]
    x, dy, w, bias, bg, n_live = (c[k] for k in ("x", "dy", "w", "bias",
                                                  "bg", "n_live"))
    b, e = c["block_rows"], w.shape[0]
    fns = {}
    for label, mod in (("other", og), ("this", gm)):
        fns[label] = {
            "k3": lambda mod=mod: mod.gmm(x, w, bg, n_live, bias=bias,
                                          block_rows=b),
            "k4": lambda mod=mod: mod.tgmm(x, dy, bg, e, block_rows=b,
                                           with_rowsum=True,
                                           n_live_blocks=n_live)}
        for name in getattr(og, "ACTIVATIONS", {}):
            fn = {"gelu_tanh": mod.gelu_tanh, "gelu": F.gelu, "relu": F.relu,
                  "silu": F.silu, "sigmoid": torch.sigmoid,
                  "tanh": torch.tanh}[name]
            fns[label][f"b2_{name}"] = (
                lambda mod=mod, fn=fn: mod.gmm(x, w, bg, n_live, bias=bias,
                                               block_rows=b, activation=fn))
    out = {"bitwise": {
        k: torch.equal(fns["other"][k](), fns["this"][k]())
        for k in fns["other"] if k != "k4"}}
    out["bitwise"]["k4"] = all(
        torch.equal(p, q) for p, q in zip(fns["other"]["k4"](),
                                          fns["this"]["k4"]()))
    for kernel in fns["other"]:
        times = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            times[label].append(per_launch_ms(fns[label][kernel]))
        out[f"{kernel}_ms"] = {k: sum(v) / 2 for k, v in times.items()}
    out["ptxas_other"] = ptxas_lines(og._build)
    # the instructions of the kernels both trees have, the same or not:
    # the wgmma kernels without an activation (named with ACT = 0 here) and
    # tgmm's
    ours, theirs = sass(gm._build), sass(og._build)
    out["same_sass"] = {name: ours.get(name.replace("EE", "ELi0EE", 1)
                                       if name.startswith("gmm_wgmma")
                                       else name) == code
                        for name, code in theirs.items()
                        if "wgmma" in name}
    return out


def sass(build, lib: str = "gmm") -> dict:
    """Kernel -> its instructions (``cuobjdump -sass`` of the library's
    build, addresses and encodings dropped), the kernel named without the
    anonymous namespace's per-build prefix."""
    so = build._build(lib)
    tool = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(\d+(?:t?gmm|group)\w+)", line)
        if m:
            name = re.sub(r"^\d+", "", m.group(1))
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]+\*/", line):
            out[name].append(line.split("*/", 1)[1].split(";")[0].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="another checkout whose K3/K4 to time and compare "
                         "with this one's")
    args = ap.parse_args()
    result = run(args.other)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
