"""The port's runnable examples, run as a user runs them, on the CPU: the
model-update lifecycle, the quickstart and the end-to-end serving driver
against the reference's, and the serve launcher on the MoE and xLSTM
families."""
import os
import pathlib
import re
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


TIMINGS = re.compile(r"\d+\.\d+s|\d+ events/s|p(50|99)=\d+\.\d+ms")
SCORE = re.compile(r"score=(\d+\.\d+)")


def _masked(lines):
    """Lines with their timings and scores masked, and the scores."""
    scores = [float(m) for line in lines for m in SCORE.findall(line)]
    return [SCORE.sub("score=?", TIMINGS.sub("?", line))
            for line in lines], scores


def test_serve_e2e_prints_the_reference_examples_lines(capsys):
    """The port's ``examples/serve_e2e.py`` on the CPU with the reference
    example's weights (its experts' ``init`` at the same seeds, through
    ``convert.model_from_numpy``) against the reference example run in
    this process, 20 windows of 32: every printed line equal once the
    timings are masked (physical models, shadow evaluations, the Eq.-5
    gate, the predictor and routing version), but the warm-up line, whose
    wording names what each package warms; the printed score within 2e-4;
    and every served score of the windows within bf16's 5e-2 (the experts
    compute in bfloat16)."""
    import runpy

    import jax
    import numpy as np
    from jax.experimental import pallas as pl

    from repro.models.model import Model as JModel
    from repro.serving.server import MuseServer as JServer
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve_e2e
    from repro_torch.serving.server import MuseServer

    make = serve_e2e.make_transformer_expert

    def with_reference_weights(arch, seed, seq_len=32, *, device,
                               params=None):
        ref = JModel(get_smoke_config(arch)).init(jax.random.key(seed))
        return make(arch, seed, seq_len, device=device,
                    params=jax.tree.map(np.asarray, ref))

    served = {"port": [], "reference": []}

    def recording(cls, key):
        score_batch = cls.score_batch

        def wrapped(self, requests):
            out = score_batch(self, requests)
            served[key].extend(r.score for r in out)
            return out
        return wrapped

    argv = ["--batches", "20", "--batch", "32"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve_e2e, "make_transformer_expert",
                   with_reference_weights)
        mp.setattr(MuseServer, "score_batch", recording(MuseServer, "port"))
        capsys.readouterr()
        serve_e2e.main([*argv, "--device", "cpu"])
        got = capsys.readouterr().out.splitlines()
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx, **_: ref[idx],
                       raising=False)
        mp.setattr(JServer, "score_batch", recording(JServer, "reference"))
        mp.setattr(sys, "argv", ["serve_e2e.py", *argv])
        runpy.run_path(str(ROOT / "examples" / "serve_e2e.py"),
                       run_name="__main__")
        want = capsys.readouterr().out.splitlines()
    jax.clear_caches()
    got_lines, got_scores = _masked(got)
    want_lines, want_scores = _masked(want)
    assert len(got_lines) == len(want_lines) == 7
    assert got_lines[1].startswith("warm-up") \
        and want_lines[1].startswith("warm-up")
    assert got_lines[:1] + got_lines[2:] == want_lines[:1] + want_lines[2:]
    assert "open: True" in got_lines[4]
    assert len(got_scores) == len(want_scores) == 1
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=2e-4)
    assert len(served["port"]) == len(served["reference"]) == 20 * 32 + 2
    np.testing.assert_allclose(served["port"], served["reference"],
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-1.3b"])
def test_serve_launcher_serves_the_moe_and_xlstm_families(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu``: a prefill, decode steps and T^Q on each risk score."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--prompt-len", "40",
         "--decode-steps", "3"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "prefill 4x40" in proc.stdout
    line = proc.stdout.strip().splitlines()[-1]
    scores = [float(x) for x in line.split("[")[1].rstrip("]").split()]
    assert len(scores) == 4 and all(0.0 <= s <= 1.0 for s in scores)
