"""Multi-host runtime smoke: 2 real processes under jax.distributed.

The reference has no multi-node story; BASELINE makes it this build's scope
(SURVEY.md §5.8). The virtual 8-device CPU mesh used elsewhere validates
sharding semantics but never exercises ``mesh.init_distributed`` — this
test launches scripts/multihost_smoke.py, which spawns two local processes,
initializes the distributed runtime over localhost gRPC, builds one global
2x2-device mesh, and runs DP detect + distributed (psum) bundle adjustment
against their single-device equivalents. The workers run on the CPU
backend only (``JAX_PLATFORMS=cpu`` in their environment).
"""

import pytest
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.heavy
def test_two_process_distributed_smoke():
    env = dict(os.environ)
    env["SMOKE_PORT"] = "17846"  # avoid clashes with manual runs
    env["JAX_PLATFORMS"] = "cpu"  # the script's parent stays off any GPU
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "multihost_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    report = proc.stdout + proc.stderr
    assert proc.returncode == 0, report
    assert "[role 0] OK" in report and "[role 1] OK" in report, report
    assert "distributed BA ok" in report, report
