"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each source in ``csrc/`` compiles, at first use, into a shared library
with a plain C interface under ``kernels/_build/`` (listed in
``.gitignore``); the file name carries a hash of the sources and flags,
so an edited kernel never loads a stale build. :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.

The target is ``sm_90a`` (Hopper). There is deliberately no
``--use_fast_math`` / ``-ftz=true``: the kernels write the reference's
flush of subnormals out where it matters (see ``csrc/mx_codec.cuh``) and
need IEEE division and ``expf`` everywhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: library name -> CUDA source in ``csrc/``
SOURCES = {"mx_attention_ragged": "mx_attention_ragged.cu",
           "mx_attention_paged": "mx_attention_paged.cu",
           "mx_attention_decode": "mx_attention_decode.cu",
           "mx_quantize": "mx_quantize.cu",
           "mx_matmul": "mx_matmul.cu",
           "mx_repack": "mx_repack.cu",
           "mx_megakernel": "mx_megakernel.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "source on the machine with the card")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns ``{name: seconds}`` for the libraries built by this call.
    Raises ``RuntimeError`` with the compiler output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name, src in SOURCES.items():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}:\n{log}")
            continue
        if verbose and log:
            print(log.strip())
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
