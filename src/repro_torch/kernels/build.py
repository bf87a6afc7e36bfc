"""Build and load the port's CUDA sources (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with `ctypes`.  The library goes
to ``build/repro_torch/`` at the root of the checkout, under a name keyed
by a hash of the source and the flags, so a fresh checkout builds on
first use and an edited source rebuilds.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>.ptxas.txt``.

Nothing is built when this module is imported: the first kernel launch
(or `ensure_built`) builds.
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


def ensure_built(name: str) -> float | None:
    """Build ``csrc/<name>.cu`` unless its library is already there.

    Returns the seconds ``nvcc`` took, or None when nothing was built.

    Raises:
      RuntimeError: when ``nvcc`` fails; the message holds its output.
    """
    final = library_path(name)
    if final.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    final.with_suffix(".ptxas.txt").write_text(proc.stdout)
    os.replace(tmp, final)              # atomic: concurrent builders agree
    return seconds


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output kept from building ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if missing)."""
    ensure_built(name)
    return ctypes.CDLL(str(library_path(name)))
