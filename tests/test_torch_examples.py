"""The port's runnable examples, end to end on the CPU.

`examples/snn_multicore_torch.py` runs as a real subprocess with the JAX
example's smoke knobs (2 train steps, an evaluation batch of 16) and
``--device cpu``, and must print the JAX example's markers.  So do the
LM examples (`quickstart_torch.py`, `train_lm_torch.py`,
`serve_lm_torch.py`) with their JAX twins' smoke knobs and flags.  A
second run of each checks that it never loads JAX or the JAX package.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "snn_multicore_torch.py")
MARKERS = ("[snn] accuracy", "[interface]", "[ppa]", "[noc]")


def _run(*args, code=None, script=SCRIPT, env=()):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "SNN_STEPS": "2", "SNN_EVAL_BATCH": "16", **dict(env)}
    cmd = ([sys.executable, script, *args] if code is None
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


def _lm_examples(tmp):
    """script -> (arguments, environment, markers), with the JAX
    examples' smoke knobs; checkpoints under ``tmp``."""
    return {
        "quickstart_torch.py": (
            ["--device", "cpu"],
            {"QUICKSTART_STEPS": "2", "QUICKSTART_GEN_STEPS": "4",
             "QUICKSTART_CKPT_DIR": os.path.join(tmp, "quickstart")},
            ("model:", "checkpointed: 2", "generated:")),
        "train_lm_torch.py": (
            ["--device", "cpu", "--arch", "gemma3-12b", "--steps", "3",
             "--batch", "4", "--seq", "32", "--microbatch", "2",
             "--ckpt-dir", os.path.join(tmp, "train_lm")],
            {}, ("[train_lm] gemma3-12b-smoke", "[train_lm] done: loss")),
        "serve_lm_torch.py": (
            ["--device", "cpu", "--arch", "llama3.2-3b", "--steps", "4"],
            {}, ("[serve] llama3.2-3b", "lane 3:")),
    }


@pytest.mark.parametrize("script", ["quickstart_torch.py", "train_lm_torch.py",
                                    "serve_lm_torch.py"])
def test_lm_example_runs_end_to_end_on_the_cpu(script, tmp_path):
    args, env, markers = _lm_examples(str(tmp_path))[script]
    path = os.path.join(REPO, "examples", script)
    proc = _run(*args, script=path, env=env)
    assert proc.returncode == 0, (
        f"exited {proc.returncode}\n--- stdout ---\n{proc.stdout[-2000:]}"
        f"\n--- stderr ---\n{proc.stderr[-2000:]}")
    for marker in markers:
        assert marker in proc.stdout, f"{marker!r} missing from output"
    args, env, _ = _lm_examples(str(tmp_path / "again"))[script]
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{path!r}, *{args!r}]\n"
        f"runpy.run_path({path!r}, run_name='__main__')\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro')))\n")
    proc = _run(code=code, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-500:]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b",
                                  "hubert-xlarge", "phi-3-vision-4.2b",
                                  "deepseek-v2-236b"])
def test_lm_examples_take_every_registry_arch(arch, tmp_path):
    """train_lm_torch.py trains each family's smoke config on its own
    batches; serve_lm_torch.py serves it, and refuses an encoder-only
    arch with the JAX example's message."""
    train = _run("--device", "cpu", "--arch", arch, "--steps", "2",
                 "--batch", "2", "--seq", "32", "--ckpt-dir",
                 str(tmp_path / "ckpt"),
                 script=os.path.join(REPO, "examples", "train_lm_torch.py"))
    assert train.returncode == 0, train.stderr[-2000:]
    assert f"[train_lm] {arch}-smoke" in train.stdout
    serve = _run("--device", "cpu", "--arch", arch, "--steps", "3",
                 script=os.path.join(REPO, "examples", "serve_lm_torch.py"))
    if arch == "hubert-xlarge":
        assert serve.returncode != 0
        assert f"{arch} is encoder-only - no decode" in serve.stderr
    else:
        assert serve.returncode == 0, serve.stderr[-2000:]
        assert f"[serve] {arch}" in serve.stdout and "lane 3:" in serve.stdout
