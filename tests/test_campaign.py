"""Campaign driver crash/resume drill, tiny.

Runs examples/flagship_campaign.py twice as REAL subprocesses: the first
invocation hard-exits (os._exit 3) mid-epoch at a step that is not a
checkpoint boundary; the second restores the step-granular checkpoint,
fast-forwards the identical shuffled batch order, and completes. Asserts
the operator-facing contract: exact step accounting across the seam, a
single monotone loss curve spanning both processes, and a recorded resume
seam. Counterpart capability: the reference's epoch loop has no resume at
all (pretrain_filtered_amazon.py:353-614 restarts from scratch).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "flagship_campaign.py")


def _run(tmp, crash_at, out):
    cmd = [
        sys.executable, SCRIPT, "--platform", "cpu", "--tiny",
        "--savedir", str(tmp), "--out", str(out),
        "--crash-at-step", str(crash_at),
    ]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("campaign")
    out1, out2 = tmp / "s1.json", tmp / "s2.json"
    # step 18 is NOT a multiple of ckpt-every (4): the resume must replay
    # the two steps since the step-16 checkpoint
    r1 = _run(tmp / "run", 18, out1)
    r2 = _run(tmp / "run", -1, out2)
    return r1, r2, out1, out2


class TestCampaignCrashResume:
    def test_crash_exit_code(self, campaign):
        r1, _, out1, _ = campaign
        assert r1.returncode == 3, r1.stderr[-2000:]
        assert not out1.exists()  # died before writing a summary

    def test_resume_completes(self, campaign):
        _, r2, _, out2 = campaign
        assert r2.returncode == 0, r2.stderr[-2000:]
        s = json.loads(out2.read_text())
        assert s["steps_total"] == 2 * s["steps_per_epoch"]
        # resumed from the last checkpoint BEFORE the crash step
        assert s["resume_seams"] == [
            {"epoch": 0, "batch_idx": 16, "global_step": 16}
        ]

    def test_loss_curve_spans_both_processes(self, campaign):
        _, _, _, out2 = campaign
        s = json.loads(out2.read_text())
        steps = [c[0] for c in s["loss_curve"]]
        assert steps == sorted(steps)
        assert steps[0] <= 4 and steps[-1] == s["steps_total"]
        losses = [c[1] for c in s["loss_curve"]]
        assert all(abs(v) < 1e3 for v in losses)

    def test_replayed_steps_reproduce(self, campaign):
        # crash at 18, ckpt at 16: steps 17-18 ran in BOTH processes with
        # (restored state, fold_in rng, same shuffle) — losses must match
        _, _, _, out2 = campaign
        s = json.loads(out2.read_text())
        assert s["replay_loss_max_dev"] <= 1e-4, s["replay_loss_max_dev"]
