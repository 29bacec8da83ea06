"""Build and load a CUDA source of ``csrc/`` as a shared library.

Each kernel source has a plain C interface. It is compiled with ``nvcc``
(``sm_90a``) at first use into ``build/`` beside the package, under a name
that carries the source's hash (an edited source is rebuilt), and loaded with
``ctypes``. nvcc's output is kept beside the library as ``.log``. The
hash covers the files of ``csrc/`` that the source includes by a quoted
``#include``, and those they include.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Optional

PACKAGE = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE.parent / "build"
LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return nvcc


class CudaLibrary:
    """One ``csrc/`` source, built once per source version and loaded once
    per process. ``declare`` sets the ``argtypes``/``restype`` of the
    library's functions after loading."""

    def __init__(self, source_name: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = PACKAGE / "csrc" / source_name
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def sources(self) -> List[Path]:
        """The source and the files it includes by a quoted ``#include``,
        transitively, each once, in the order they are first named."""
        out: List[Path] = []
        todo = [self.source]
        while todo:
            path = todo.pop(0)
            if path in out:
                continue
            out.append(path)
            todo.extend(path.parent / name for name in
                        LOCAL_INCLUDE.findall(path.read_text()))
        return out

    def path(self) -> Path:
        """The shared object built from the current sources."""
        digest = hashlib.sha256()
        for path in self.sources():
            digest.update(path.read_bytes())
        tag = digest.hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{tag}.so"

    def build(self) -> None:
        """Compile the source unless its library exists; raise with nvcc's
        errors if it fails."""
        so = self.path()
        if so.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True,
        )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
        os.replace(tmp, so)

    def load(self) -> ctypes.CDLL:
        """Build if needed, then load (once) and declare the functions."""
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path()))
            self._declare(lib)
            self._lib = lib
        return self._lib
