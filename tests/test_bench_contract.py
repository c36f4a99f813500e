"""Driver-contract smoke: bench.py must print ONE parseable JSON line with
the required keys.
Runs the toy shapes of a forced-CPU run in a subprocess (the GPU numbers
are the bench's job, not this test's)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_emits_one_json_line_with_required_keys():
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import sys; sys.path.insert(0, %r); "
            "import bench; bench.main()" % REPO,
        ],
        capture_output=True,
        text=True,
        timeout=900,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    json_lines = [
        ln for ln in proc.stdout.splitlines() if ln.startswith("{")
    ]
    assert len(json_lines) == 1, proc.stdout
    rec = json.loads(json_lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec, key
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["unit"] == "queries/sec"
    # extra recorded paths ride the same line without breaking the parse
    assert any(k.startswith("binary_sign_qps") for k in rec)
    assert "int8x8_qps" in rec and "int8x8_approx_qps" in rec
    assert rec["int8x8_value_recall10"] >= 0.99

