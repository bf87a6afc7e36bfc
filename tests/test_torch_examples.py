"""The port's runnable example, end to end on the CPU.

`examples/snn_multicore_torch.py` runs as a real subprocess with the JAX
example's smoke knobs (2 train steps, an evaluation batch of 16) and
``--device cpu``, and must print the JAX example's markers.  A second
run checks that the port's example never loads JAX or the JAX package.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "snn_multicore_torch.py")
MARKERS = ("[snn] accuracy", "[interface]", "[ppa]", "[noc]")


def _run(*args, code=None):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "SNN_STEPS": "2", "SNN_EVAL_BATCH": "16"}
    cmd = ([sys.executable, SCRIPT, *args] if code is None
           else [sys.executable, "-c", code])
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_snn_example_runs_end_to_end_on_the_cpu():
    proc = _run("--device", "cpu")
    assert proc.returncode == 0, (
        f"exited {proc.returncode}\n--- stdout ---\n{proc.stdout[-2000:]}"
        f"\n--- stderr ---\n{proc.stderr[-2000:]}")
    for marker in MARKERS:
        assert marker in proc.stdout, f"{marker!r} missing from output"
    assert "step  0 loss" in proc.stdout
    assert "multicast_tree cam_searches" in proc.stdout
    assert "greedy     traffic_cost" in proc.stdout


def test_snn_example_loads_no_jax():
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{SCRIPT!r}, '--device', 'cpu']\n"
        f"runpy.run_path({SCRIPT!r}, run_name='__main__')\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro')))\n")
    proc = _run(code=code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-500:]
