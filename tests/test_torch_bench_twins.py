"""The port's benchmark twins against the JAX package's scripts, at tiny
sizes on the CPU: each twin's row carries its JAX script's keys, the
``scaling`` harness runs its worlds and reports as the JAX one does
(``tests/test_bench_harness.py``), the decode twin's bytes a token and
tokens are the JAX accounting's and ``generate()``'s, and ``vit_train``
builds each ViT size with the JAX model's parameter count.  The rows'
numbers are not checked here beyond being positive: the card measures
them."""

import jax
import numpy as np
import pytest
import torch

from tpu_dist_torch.benchmarks import (attention, generate, input_pipeline,
                                       scaling, vit_train)

TINY_LM = dict(dim=32, depth=2, heads=4, vocab=64)

# the keys of the JAX scripts' rows: benchmarks/attention.py:172-188 (each
# implementation's dict :154-159; the TPU-only note left out),
# input_pipeline.py:189-205, scaling.py:77-89
JAX_ATTENTION_KEYS = {"metric", "shape", "rows"}
JAX_ATTENTION_ROW_KEYS = {"seq_len", "flash", "dense",
                          "flash_speedup_fwd_bwd"}
JAX_IMPL_KEYS = {"fwd_ms", "fwd_bwd_ms", "fwd_tflops", "fwd_bwd_tflops"}
JAX_INPUT_PIPELINE_KEYS = {
    "metric", "host_augment_images_per_sec", "raw_host_images_per_sec",
    "device_augment_images_per_sec", "resnet50_bf16_step_images_per_sec",
    "chip_consume_images_per_sec", "loader_over_step",
    "loader_keeps_chip_fed", "host_cores",
    "host_augment_cores_to_feed_estimate", "batch", "image_size",
    "raw_size", "note"}
JAX_SCALING_KEYS = {"metric", "step_ms", "serialized_efficiency",
                    "per_device_batch", "note"}

@pytest.fixture(autouse=True)
def _two_threads():
    """torch's intra-op threads held to two for each test: the suite runs
    several files at once, and a small model's ops on every core of a
    shared host spend their time contending, not computing."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    try:
        yield
    finally:
        torch.set_num_threads(saved)



def test_scaling_harness_runs_and_reports():
    """Two worlds of gloo ranks (the JAX harness test's call): a step time
    and a serialized efficiency each, world 1's exactly 1."""
    r = scaling.run(device="cpu", per_device_batch=4, steps=4, reps=1,
                    world_sizes=(1, 2))
    assert r["metric"] == "ddp_weak_scaling_overhead_virtual_cpu_mesh"
    assert set(r["step_ms"]) == {"1", "2"}
    assert set(r["serialized_efficiency"]) == {"1", "2"}
    assert r["serialized_efficiency"]["1"] == 1.0
    assert all(v > 0 for v in r["step_ms"].values())
    assert JAX_SCALING_KEYS <= set(r)
    with pytest.raises(ValueError, match="start at 1"):
        scaling.run(device="cpu", world_sizes=(2,))


@pytest.fixture(scope="module")
def jax_decode_rows():
    from benchmarks import generate as jgen
    kw = dict(batch=2, prompt_len=8, gen_long=12, gen_short=4, reps=1,
              **TINY_LM)
    return {int8: jgen.run(int8_weights=int8, **kw) for int8 in (False, True)}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_generate_row_matches_jax(jax_decode_rows, int8):
    """The row's keys, model description and bytes a token are the JAX
    script's for the same configuration (bf16 parameters; int8 Linears,
    head and attention projections with bf16 scales)."""
    want = jax_decode_rows[int8]
    got = generate.run(batch=2, prompt_len=8, gen_long=12, gen_short=4,
                       reps=1, int8_weights=int8, device="cpu", **TINY_LM)
    assert set(want) <= set(got)
    assert got["metric"] == want["metric"]
    for k in ("depth", "dim", "heads", "vocab", "cache_dtype", "weights"):
        assert got["model"][k] == want["model"][k], k
    assert round(got["weight_read_mb_per_token"], 1) == \
        want["weight_read_mb_per_token"]
    assert round(got["weight_total_mb"], 1) == want["weight_total_mb"]
    assert got["value"] > 0 and got["ms_per_token"] > 0


def test_generate_read_bytes_equal_jax_accounting():
    """Exact bytes: every leaf but the embedding tables, as the JAX
    ``_per_token_read_bytes`` counts them on the same tree."""
    from benchmarks import generate as jgen
    for int8 in (False, True):
        jmodel, jparams = jgen._build_lm(32, int8, **TINY_LM)
        want = jgen._per_token_read_bytes(jmodel, jparams)
        model = generate.build_lm(32, int8, device="cpu", **TINY_LM)
        assert generate.per_token_read_bytes(model) == want, int8


def test_generate_tokens_are_generates():
    """The twin's greedy tokens equal ``generate()`` on the same seeded
    model and prompt."""
    row = generate.run(batch=2, prompt_len=8, gen_long=12, gen_short=4,
                       reps=1, device="cpu", keep_tokens=True, **TINY_LM)
    model = generate.build_lm(20, False, device="cpu", **TINY_LM)
    prompt = torch.tensor(row["prompt"])
    want = model.generate(prompt, 12, cache_dtype=torch.bfloat16)
    assert row["tokens"] == want.tolist()
    assert len(row["tokens"][0]) == 20


def test_generate_long_context_and_prefill_rows():
    lc = generate.run_long_context_int8_cache(
        prompt_len=16, gen_long=12, gen_short=4, reps=1, device="cpu",
        **{k: v for k, v in TINY_LM.items()})
    assert {"metric", "value", "unit", "int8_cache_speedup_vs_bf16_cache",
            "prompt_len", "bf16_cache", "int8_cache", "n_chips"} <= set(lc)
    assert lc["int8_cache"]["tokens_per_sec"] > 0
    pf = generate.run_prefill(batch=2, prompt_len=16, reps=1, device="cpu",
                              **TINY_LM)
    assert {"metric", "value", "unit", "prefill_ms", "achieved_model_tflops",
            "batch", "prompt_len", "gross_timing_fallback",
            "n_chips"} <= set(pf)
    assert pf["value"] > 0


def test_attention_row_keys_match_jax():
    """The JAX row's keys at tiny shapes (the library yardstick's row,
    ``library_sdpa`` where the JAX script has ``stock_jax_kernel``, is
    timed on a card only), the sweep and its crossover."""
    r = attention.run(b=1, h=2, d=16, rows=((64, True, None),
                                            (128, False, 1)),
                      sweep=(32, 64), reps=1, device="cpu")
    assert JAX_ATTENTION_KEYS <= set(r)
    assert JAX_ATTENTION_ROW_KEYS <= set(r["rows"][0])
    assert "dense" not in r["rows"][1]
    for impl in ("flash", "dense"):
        assert JAX_IMPL_KEYS <= set(r["rows"][0][impl])
        assert r["rows"][0][impl]["fwd_ms"] > 0
    assert [s["seq_len"] for s in r["sweep"]] == [32, 64]
    assert r["crossover_seq_len"] in (None, 32, 64)
    assert r["flash_min_seq"] == 1024
    # the calls a row makes, against which a card's launches are held
    assert r["rows"][0]["flash_calls"] == {"fwd": 6, "bwd": 3}


def test_input_pipeline_row_keys_match_jax():
    r = input_pipeline.run(batch=4, image_size=32, raw_size=40,
                           n_images=8, workers=(0, 2), step_batch=2,
                           repeats=1, reps=1, device="cpu")
    assert JAX_INPUT_PIPELINE_KEYS <= set(r)
    assert set(r["host_augment_images_per_sec"]) == {0, 2}
    for k in ("raw_host_images_per_sec", "device_augment_images_per_sec",
              "resnet50_bf16_step_images_per_sec",
              "chip_consume_images_per_sec"):
        assert r[k] > 0, k
    assert isinstance(r["loader_keeps_chip_fed"], bool)


@pytest.mark.parametrize("name", vit_train.MODELS)
def test_vit_train_builds_each_size_like_jax(name):
    from tpu_dist import models as jmodels
    jm = getattr(jmodels, name)(num_classes=1000)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    ddp, x, y = vit_train.build(batch=1, device="meta", model=name)
    got = sum(p.numel() for p in ddp.module.parameters())
    assert got == want
    assert tuple(x.shape) == (1, 3, 224, 224) and tuple(y.shape) == (1,)
    tokens = (224 // vit_train.PATCH[name]) ** 2 + 1
    assert vit_train.flops_per_image(got, vit_train.PATCH[name]) == \
        6 * got * tokens


def test_vit_flops_default_is_the_jax_count():
    """The JAX script's count for ViT-B/16: 3 × 2 × 86,567,656 × 197."""
    assert vit_train.flops_per_image(86_567_656, 16) == \
        3 * 2 * 86_567_656 * 197


def test_jax_scripts_keep_these_keys():
    """The key sets above are the JAX scripts' own: their literal keys
    appear in the sources (a renamed JAX key fails here)."""
    import inspect

    from benchmarks import attention as ja
    from benchmarks import input_pipeline as jip
    from benchmarks import scaling as js
    for mod, keys in ((ja, JAX_ATTENTION_KEYS | JAX_ATTENTION_ROW_KEYS
                       | JAX_IMPL_KEYS),
                      (jip, JAX_INPUT_PIPELINE_KEYS),
                      (js, JAX_SCALING_KEYS)):
        src = inspect.getsource(mod)
        for k in keys:
            assert f'"{k}"' in src, (mod.__name__, k)
