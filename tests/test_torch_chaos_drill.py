"""The chaos drill matrix of the port (``resilience/drill.py`` and
``python -m swiftsnails_tpu_torch.tools.chaos_drill``) on the CPU: the JAX
package's ``tests/test_chaos_drill.py`` cases, the whole matrix (each
drill recovers), and each drill's schedule-determined fields against the
JAX package's drill on the same seeds. The losses are not compared: the
port's steps draw from ``step_generator``, the JAX steps from ``fold_in``."""

import pytest
import torch

from swiftsnails_tpu.resilience import drill as jax_drill

from swiftsnails_tpu_torch.resilience import drill
from swiftsnails_tpu_torch.resilience.drill import (
    DRILLS,
    FAST_DRILLS,
    chaos_bench,
    drill_ckpt_walkback,
    drill_io_error,
    drill_nan_burst,
    run_drill_matrix,
)
from swiftsnails_tpu_torch.tools import chaos_drill


@pytest.fixture(autouse=True)
def _one_thread():
    """The dense push (``index_put_`` with accumulate) is serial, so run to
    run equal, with one intra-op thread on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_drill_names_and_bar_are_the_jax_packages():
    assert DRILLS == jax_drill.DRILLS and FAST_DRILLS == jax_drill.FAST_DRILLS
    assert set(FAST_DRILLS) <= set(DRILLS)
    assert drill.LOSS_PARITY_BAR == jax_drill.LOSS_PARITY_BAR


def test_nan_burst_recovers_with_finite_tables(tmp_path):
    res = drill_nan_burst(str(tmp_path), device="cpu")
    assert res["recovered"], res
    assert res["tables_finite"] and res["trips"] == 3
    assert res["steps_skipped"] == 3  # burst batches skipped, run completed


def test_io_error_retries_instead_of_dying(tmp_path):
    res = drill_io_error(str(tmp_path), device="cpu")
    assert res["recovered"], res
    assert res["injected"] == 2 and res["steps"] == 12


def test_ckpt_walkback_restores_newest_intact(tmp_path):
    res = drill_ckpt_walkback(str(tmp_path), device="cpu")
    assert res["recovered"], res
    assert res["restored_step"] < res["corrupted_step"]
    assert res["cursor"]["step"] == res["restored_step"]


def test_run_drill_matrix_fast_all_recover(tmp_path):
    results = run_drill_matrix(fast=True, workdir=str(tmp_path), device="cpu")
    assert set(results) == set(FAST_DRILLS)
    failed = {k: v for k, v in results.items() if not v.get("recovered")}
    assert not failed, failed


def test_full_drill_matrix_all_recover(tmp_path):
    """The whole matrix, the tier drills over f32 and int8 masters and the
    preemption walk-back included (the JAX package marks its run slow; the
    port's takes about a second on the CPU)."""
    results = run_drill_matrix(fast=False, workdir=str(tmp_path), device="cpu")
    assert list(results) == list(DRILLS)
    failed = {k: v for k, v in results.items() if not v.get("recovered")}
    assert not failed, failed
    assert results["tier_bitflip_int8"]["plane_probe"] == {
        "code_detected": True, "scale_detected": True}


# the fields a drill's fault schedule decides, not its random streams
_SCHEDULED = {
    "nan_burst": ("steps", "trips", "steps_skipped", "tables_finite", "recovered"),
    "inf_update": ("steps", "trips", "steps_skipped", "tables_finite", "recovered"),
    "row_poison": ("steps", "trips", "steps_skipped", "tables_finite", "recovered"),
    "io_error": ("steps", "injected", "tables_finite", "recovered"),
    "ckpt_walkback": ("corrupted_step", "restored_step", "cursor", "recovered"),
    "preempt_resume": ("preempted", "died_at_step", "final_save_step", "restored_step",
                       "steps_lost", "recovered"),
    "tier_bitflip": ("steps", "rebuilt_from_step", "master_dtype", "recovered"),
}


@pytest.mark.parametrize("name", list(_SCHEDULED))
def test_drill_matches_jax_on_its_schedule(tmp_path, name):
    mine = drill._DRILL_FNS[name](str(tmp_path / "p"), device="cpu")
    theirs = jax_drill._DRILL_FNS[name](str(tmp_path / "j"))
    assert {k: mine.get(k) for k in _SCHEDULED[name]} == {
        k: theirs.get(k) for k in _SCHEDULED[name]}
    assert mine["recovered"]


def test_chaos_bench_small_recovers(tmp_path):
    block = chaos_bench(workdir=str(tmp_path), small=True, device="cpu")
    assert block["recovered_all"], block["drills"]
    assert set(block["drills"]) == set(FAST_DRILLS)
    assert block["control_words_per_sec"] > 0 and block["guard_words_per_sec"] > 0
    assert block["nan_drill"]["trips"] == 3


def test_chaos_drill_tool_exits_zero(tmp_path, capsys):
    rc = chaos_drill.main(["--fast", "--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "RECOVERED" in out and "UNRECOVERED" not in out


def test_chaos_drill_tool_exit_code_on_an_unrecovered_drill(tmp_path, capsys, monkeypatch):
    """A drill that raises is unrecovered: the matrix records the error and
    the tool exits 1, as the JAX tool does."""
    def boom(workdir=None, device=None):
        raise RuntimeError("drill broke")

    monkeypatch.setitem(drill._DRILL_FNS, "io_error", boom)
    rc = chaos_drill.main(["--fast", "--json", "--device", "cpu",
                           "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and '"failed": ["io_error"]' in out and "drill broke" in out
