"""The port's synthetic 3DMatch-protocol workflow on the CPU at its small
scale: ``scripts.synthetic_benchmark --scale small --steps 2
--num_workers 0 --device cpu`` builds the scenes, writes the gt.log /
gt.info protocol files, calibrates the caps, trains one epoch through the
Trainer, dumps every test pair through the Tester and runs
``python -m geotransformer_tpu_torch.scripts.eval`` on the dumps in a
process of its own, whose RR/IR/FMR table it prints.
"""

import math

import pytest
import torch

from geotransformer_tpu_torch.scripts import synthetic_benchmark


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, where more threads a worker only add to the total CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_small_workflow_through_the_eval_process(tmp_path, capsys):
    out = tmp_path / "synth"
    summary = synthetic_benchmark.main(["--scale", "small", "--steps", "2", "--num_workers", "0",
                                        "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    _, train_set, test_set = synthetic_benchmark.build_sets("small")
    # whole epochs covering the steps: one epoch of every training pair
    assert f"trained {len(train_set)} steps" in printed
    assert "tester metrics:" in printed
    assert all(math.isfinite(v) for v in summary.values())
    assert sorted(summary) == ["IR", "PIR", "RMSE", "RR", "RRE", "RTE"]
    # the evaluator's table, from its own process
    assert "Overall (lgr):" in printed and "Per scene:" in printed
    assert "synth-test-0: RR=" in printed
    for name in ("gt.log", "gt.info"):
        assert (out / "benchmark" / "synth-test-0" / name).stat().st_size > 0
    assert len(list((out / "features" / "synth-test-0").glob("*.npz"))) == len(test_set)
    assert (out / "registration" / "synth-test-0" / "est.log").exists()
    assert (out / "train" / "checkpoints" / "1" / "state.pt").exists()
