"""Build and load the port's CUDA kernels.

A kernel is one ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Libraries land
in ``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
Nothing is built at import time: :func:`load` builds on first use, and
:func:`build_all` compiles several sources at once (one ``nvcc`` process per
source, all started together, then joined).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_KERNELS = Path(__file__).resolve().parent
# every kernel of the port, one source each (what build_all builds by default)
SOURCES = tuple(_KERNELS / name / "csrc" / f"{name}.cu"
                for name in ("paged_decode", "flash_prefill", "rwkv6_scan", "mamba2_ssd"))

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.isfile(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives for the current sources
    (the ``.cu``, ``.cuh`` and ``.h`` files beside it)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(source.parent.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path] = SOURCES) -> Dict[Path, str]:
    """Compile every source whose library is not built yet (every kernel of
    the port by default), one ``nvcc`` each, all started together and then
    joined.  Returns each source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills), or ""
    when nothing was built for it; raises with the logs of the sources that
    failed once every process has ended."""
    logs: Dict[Path, str] = {s: "" for s in sources}
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return logs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source in todo:
        target = library_path(source)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, target))
    failed = []
    for source, proc, tmp, target in running:
        out, _ = proc.communicate()
        logs[source] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source.name}:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build(source: Path) -> str:
    """Compile ``source`` unless its library is built already (see
    :func:`build_all`)."""
    return build_all([source])[source]


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
