"""The port's benchmark harness (`utils.benchmark`) against the JAX
package's, and the kernel-benchmark scripts on the CPU at a small size.

The harness times on the host's clock; on a CPU tensor it waits for
nothing, so what is checked here is its bookkeeping (reps, chunks,
rotation) and `validate_result`, which is numpy only in both packages and
must count and raise alike.
"""

import numpy as np
import pytest
import torch

from unet_tpu.utils import benchmark as jax_bench
from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.scripts import bench_ops, block_timing
from unet_tpu_torch.utils import benchmark as port_bench

from tests.torch_port_util import TINY


def _pair(n_bad, size=64, seed=0):
    rng = np.random.default_rng(seed)
    expected = rng.standard_normal(size).astype(np.float32)
    actual = expected.copy()
    actual[rng.choice(size, n_bad, replace=False)] += 1.0
    return actual, expected


@pytest.mark.parametrize("n_bad", [0, 3, 25])
def test_validate_result_counts_as_the_jax_one(n_bad, capsys):
    actual, expected = _pair(n_bad)
    kw = dict(name="t", atol=1e-4, max_faults=10, raise_on_fault=False)
    got = port_bench.validate_result(actual, expected, **kw)
    port_err = capsys.readouterr().err
    want = jax_bench.validate_result(actual, expected, **kw)
    assert got == want == n_bad
    assert port_err == capsys.readouterr().err


@pytest.mark.parametrize("n_bad,size", [(3, 64), (25, 64), (0, 63)])
def test_validate_result_raises_as_the_jax_one(n_bad, size):
    actual, expected = _pair(n_bad)
    expected = expected[:size]
    with pytest.raises(jax_bench.ValidationError) as want:
        jax_bench.validate_result(actual, expected, name="t", max_faults=10)
    with pytest.raises(port_bench.ValidationError) as got:
        port_bench.validate_result(actual, expected, name="t", max_faults=10)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, AssertionError)


def test_validate_result_verbose_prints_the_first_pairs(capsys):
    actual, expected = _pair(0, size=8)
    assert port_bench.validate_result(actual, expected, verbose=True,
                                      print_first=3) == 0
    port_out = capsys.readouterr().out
    jax_bench.validate_result(actual, expected, verbose=True, print_first=3)
    assert port_out == capsys.readouterr().out and port_out.count("\n") == 3


@pytest.mark.parametrize("reps,chunks,warmup", [(20, 4, 2), (10, 4, 0),
                                                (3, 4, 1)])
def test_benchmark_counts_reps_and_rotates(reps, chunks, warmup):
    seen = []

    def fn(a):
        seen.append(a)
        return torch.ones(2) * a

    rotate = [(0,), (1,), (2,)]
    r = port_bench.benchmark(fn, reps=reps, warmup=warmup, rotate=rotate,
                             chunks=chunks)
    assert set(r) == {"mean_ms", "std_ms", "reps"}
    assert r["reps"] == max(1, reps // chunks) * chunks
    assert r["mean_ms"] >= 0 and r["std_ms"] >= 0
    calls = max(warmup, 1) + r["reps"]
    assert len(seen) == calls
    # warm-up and timed reps each walk the input sets in order
    want = ([i % 3 for i in range(max(warmup, 1))]
            + [i % 3 for i in range(r["reps"])])
    assert seen == want


def test_benchmark_without_rotation_calls_with_the_args():
    seen = []
    r = port_bench.benchmark(lambda *a: seen.append(a) or torch.zeros(1),
                             1, 2, reps=4)
    assert r["reps"] == 4 and set(seen) == {(1, 2)}


def test_trace_writes_a_chrome_trace(tmp_path):
    with port_bench.trace(str(tmp_path / "t")):
        torch.ones(64).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_bound_picks_the_larger_time():
    ms, by = port_bench.bound(3.35e9, 1.0, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = port_bench.bound(1.0, 165e9, torch.float32)  # 3xTF32: 495e12 / 3
    assert by == "operations" and ms == pytest.approx(1.0)
    assert port_bench.device_line("cpu") == "cpu"


@pytest.mark.parametrize("backward", [False, True])
def test_block_timing_split_at_tiny(backward):
    r = block_timing.measure_split(UnetConfig(**TINY), batch=2,
                                   dtype=torch.float32, backward=backward,
                                   reps=1, device="cpu")
    assert r["pass"] == ("fwd+bwd" if backward else "forward")
    assert r["full_ms"] > 0 and r["attention_free_ms"] > 0
    assert r["attention_ms"] == pytest.approx(r["full_ms"]
                                              - r["attention_free_ms"])
    assert r["attention_share"] == pytest.approx(r["attention_ms"]
                                                 / r["full_ms"])
    assert "device_alone" not in r  # only a CUDA device has one


def test_bench_ops_runs_on_the_cpu():
    r = bench_ops.run(["--device", "cpu", "--batch", "1", "--reps", "1",
                       "--dtype", "float32"])
    assert r["device"] == "cpu" and len(r["ops"]) == 11
    assert all(v["mean_ms"] > 0 for v in r["ops"].values())


def test_ab_trees_reads_the_shape_lists_and_summarises():
    """The A/B script times both trees at the current chip_smoke.py's shape
    lists (read without importing it) and reports, per case, each tree's
    fastest device-alone time and the ratio of the second tree's to the
    first's."""
    from unet_tpu_torch.utils import ab_trees
    lists = ab_trees.shape_lists("chip_smoke.py")
    assert set(lists) == set(ab_trees.SHAPE_LISTS)
    assert (8, 64, 64, 64) in lists["GN_SHAPES"]
    heads = ab_trees.timed_heads(lists)  # only the timed head sizes run
    assert set(heads["ATTN_HEAD_SHAPES"]) == {
        tuple(s) for k in ("fwd", "bwd") for s in lists["ATTN_HEAD_TIMED"][k]}
    assert heads["ATTN_HEAD_BWD_SHAPES"] == []
    case = dict(shape=[8, 64, 64, 64], dtype="torch.bfloat16", act="silu")
    turns = [("old", {"check_groupnorm": [dict(case, kernel_graph_ms=2.0)]}),
             ("new", {"check_groupnorm": [dict(case, kernel_graph_ms=1.5)]}),
             ("new", {"check_groupnorm": [dict(case, kernel_graph_ms=1.0)]}),
             ("old", {"check_groupnorm": [dict(case, kernel_graph_ms=3.0)]})]
    summary = ab_trees.summarise(turns)
    assert summary == {"check_groupnorm [8, 64, 64, 64] torch.bfloat16 silu":
                       {"old": 2.0, "new": 1.0, "ratio": 0.5}}


def test_ab_trees_keys_the_split_kernels_by_kernel_and_skips_untimed_cases():
    """`check_split_kernels` returns {kernel: cases}: the four kernels'
    cases at one shape stay apart, and the untimed ones (act "none") are
    left out."""
    from unet_tpu_torch.utils import ab_trees
    assert "SPLIT_SHAPES" in ab_trees.SHAPE_LISTS
    case = dict(shape=[32, 32, 64, 64], dtype="torch.bfloat16")

    def turn(stats_ms, sums_ms):
        return {"check_split_kernels": {
            "gn_stats": [dict(case, act="silu", kernel_graph_ms=stats_ms),
                         dict(case, act="none")],
            "gn_bwd_sums": [dict(case, act="silu", kernel_graph_ms=sums_ms)]}}
    summary = ab_trees.summarise([("old", turn(4.0, 8.0)),
                                  ("new", turn(1.0, 4.0))])
    key = "check_split_kernels {} [32, 32, 64, 64] torch.bfloat16 silu"
    assert summary == {
        key.format("gn_stats"): {"old": 4.0, "new": 1.0, "ratio": 0.25},
        key.format("gn_bwd_sums"): {"old": 8.0, "new": 4.0, "ratio": 0.5}}
