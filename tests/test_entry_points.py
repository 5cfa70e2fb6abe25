"""Entry points that reach the card: chip_smoke.py's contract, bench.py's
peak table, the compile-cache location, and the CLI without matplotlib."""

import json
import os
import types

import jax
import pytest

import bench
import chip_smoke
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils import (
    compile_cache)


def _device(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("found", ["cpu", "none"])
def test_chip_smoke_refuses_non_gpu_backend(found):
    devices = jax.devices("cpu") if found == "cpu" else []
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(devices)


def test_chip_smoke_requires_four_cards_for_four():
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu([_device("gpu", "NVIDIA H100 80GB HBM3")], 4)


def test_chip_smoke_result_line_contract():
    kind = "NVIDIA H100 80GB HBM3"
    line = chip_smoke.result_line([_device("gpu", kind)])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    four = json.loads(chip_smoke.result_line([_device("gpu", kind)] * 4))
    assert four["device"]["count"] == 4 and four["ok"] is True


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_bench_peaks_refuse_unknown_device():
    with pytest.raises(ValueError, match="no peak rates"):
        bench.device_peaks("NVIDIA A100-SXM4-80GB")


def test_bench_peaks_h100_data_sheet():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"hbm_gbps": 3350.0, "f32_tflops": 67.0}


def test_cli_skips_plots_without_matplotlib(monkeypatch, tmp_path, capsys):
    """The computation runs and one line says the plots were skipped."""
    import importlib.util

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu import (
        cli)

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    # A set variable leaves the process's cache configuration untouched.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    params = ["--scenario", "head_on", "--mode", "monte_carlo",
              "--mc_runs", "2", "--dtype", "float64",
              "--save_dir", str(tmp_path)]
    result = cli.main(params)
    out = capsys.readouterr().out
    assert out.count("skipped plots") == 1
    assert result.min_distances.shape == (2, 4)
    assert not list(tmp_path.glob("*.png"))
    assert list(tmp_path.glob("*.npz"))


def test_timing_table_csv(tmp_path):
    """timing_comparison.csv keeps the reference's columns, written with
    the csv module."""
    import csv

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.timing_analysis import (
        create_comparison_table)

    data = {k: {10: [1.0, 3.0]} for k in (
        "setup_times", "solve_times", "call_times", "cvar_setup_times",
        "cvar_solve_times", "cvar_call_times")}
    create_comparison_table(data, [10], str(tmp_path), verbose=False)
    with open(tmp_path / "timing_comparison.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Samples", "DR-CVaR Setup", "DR-CVaR Solve",
                       "DR-CVaR Call", "CVaR Setup", "CVaR Solve",
                       "CVaR Call"]
    assert rows[1] == ["10"] + ["2.0"] * 6
