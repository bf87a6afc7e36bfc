"""Build and load the port's CUDA sources (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with `ctypes`.  The library goes
to ``build/repro_torch/`` at the root of the checkout, under a name keyed
by a hash of the source and the flags, so a fresh checkout builds on
first use and an edited source rebuilds.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>.ptxas.txt``.

Nothing is built when this module is imported: the first kernel launch
(or `ensure_built`, which builds several sources in parallel) builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """The CUDA toolkit's nvcc, found the way PyTorch's own builder does."""
    from torch.utils import cpp_extension
    home = cpp_extension.CUDA_HOME
    nvcc = os.path.join(home, "bin", "nvcc") if home else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: building the port's CUDA kernels needs the CUDA "
            "toolkit (set CUDA_HOME)")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def ensure_built(*names: str) -> dict[str, float | None]:
    """Build each ``csrc/<name>.cu`` whose library is not there yet.

    One ``nvcc`` per source, all started together and then awaited, so a
    fresh checkout pays for the slowest build, not for their sum.
    Returns, per name, the seconds its ``nvcc`` took, or None when nothing
    was built.

    Raises:
      RuntimeError: when an ``nvcc`` fails; the message holds its output.
    """
    started = {}
    for name in names:
        final = library_path(name)
        if final.exists() or name in started:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, final, time.perf_counter())
    seconds = dict.fromkeys(names)
    failed = []
    for name, (proc, tmp, final, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        final.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, final)          # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output kept from building ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if missing)."""
    ensure_built(name)
    return ctypes.CDLL(str(library_path(name)))
