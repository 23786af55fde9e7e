"""The port's runnable examples, run as a user runs them, on the CPU."""
import os
import pathlib
import subprocess
import sys

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
