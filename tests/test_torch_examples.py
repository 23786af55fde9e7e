"""The port's runnable examples, run as a user runs them, on the CPU: the
model-update lifecycle, and the quickstart against the reference's."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_model_update_lifecycle_runs_on_the_cpu():
    """``python -m repro_torch.examples.model_update_lifecycle --device
    cpu``: the Fig.-3 lifecycle (deploy, shadow, validate, rolling
    promotion) prints its milestones and ends on v2."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.model_update_lifecycle",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [line.split("]")[0] + "]" for line in lines] == [
        "[deploy]", "[shadow]", "[validate]", "[rollout]", "[done]"]
    assert "3 models provisioned" in lines[0]
    assert lines[1] == "[shadow] 40000 candidate evaluations recorded"
    assert lines[3] == ("[rollout] pods 2->3->2, min ready=2, "
                        "final version=v2")
    assert lines[4].startswith("[done] client intent never changed")


def test_quickstart_prints_the_reference_examples_lines(capsys):
    """``python -m repro_torch.examples.quickstart --device cpu`` prints,
    line for line, what the reference's ``examples/quickstart.py`` prints:
    provisioning, the live score and raw expert scores, the shadow record,
    the score after the T^Q swap and after the promotion.  The reference
    runs in this process with its banked Pallas kernel in interpret mode
    (``pallas.load`` supplied for the call only)."""
    import runpy

    import jax
    from jax.experimental import pallas as pl

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == ("models provisioned: 2 (3 predictors share 2 "
                        "physical models)")
    assert lines[1].startswith("live score via bank1-predictor-v1: ")
    assert lines[2] == "shadow records written: 1"
    assert lines[4].startswith("after promotion, same intent now served by "
                               "bank1-predictor-v2 (routing v2): ")
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx, **_: ref[idx],
                       raising=False)
        capsys.readouterr()
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
        want = capsys.readouterr().out.splitlines()
    jax.clear_caches()
    assert lines == want
