"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -D<KEY>=<value>...

into ``build/kernels/`` beside the package, one shared library per source
and per layout signature (the ``-D`` values: problem structure is
compile-time so per-thread arrays stay in registers), keyed by a hash of the
signature and the sources, and loaded with ``ctypes``.  No PyTorch headers,
no ``ninja``.  A failed build raises with the compiler's output; there is
no fallback.  Nothing here runs at import: a machine without ``nvcc`` can
import every module of the package.

``host=True`` builds the same sources with ``g++`` in their host-emulation
mode (``-std=c++20 -pthread -DLANE_HOST_EMULATION -DLANE_REAL=double``: the
launch macro becomes a loop over threads, and a cooperative launch runs each
block's threads as ``std::thread``s meeting at ``std::barrier``s), which lets
a test check a kernel's arithmetic, in double, without a GPU.
The solver never takes that path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# Each source and the keys of its layout signature (its ``-D`` values).
KERNELS = {
    "ruiz": ("NDIM", "NX", "BLOCK_P"),
    "kkt_factor": ("NDIM", "NX"),
    "admm_chunk": ("NDIM", "NX"),
    "residuals": ("NDIM", "NX", "BLOCK_P"),
    "tridiag": ("B2",),
    "dense": (),
    "fast_math_check": (),
}

# The largest sizes each source is built for: (signature key, its largest
# value, the limit as the source states it).  A signature above them is
# refused before a compiler starts (start_build, so every kernel wrapper).
LIMITS = {
    "tridiag": ("B2", 32, "csrc/tridiag.cu:115: a group of threads per "
                "problem is at most one warp (B2 <= 32: N <= 16)"),
    "kkt_factor": ("NDIM", 16, "csrc/kkt_factor.cu:52: a group of threads "
                   "per problem is at most one warp (2N <= 32: N <= 16)"),
    "admm_chunk": ("NDIM", 16, "csrc/admm_chunk.cu:76: a group of threads "
                   "per problem is at most one warp (2N <= 32: N <= 16)"),
    "residuals": ("NDIM", 16, "csrc/residuals.cu:65: a group of threads per "
                  "problem is at most one warp (2N <= 32: N <= 16)"),
    "ruiz": ("NDIM", 16, "csrc/ruiz.cu: held against its plain version on "
             "the card up to N <= 16, the other lane kernels' limit"),
}


def check_limits(name: str, signature: dict) -> None:
    """Raise ``NotImplementedError`` naming the limit when ``csrc/<name>.cu``
    cannot be built for ``signature``."""
    limit = LIMITS.get(name)
    if limit is None:
        return
    key, most, what = limit
    value = signature.get(key)
    if value is not None and int(value) > most:
        raise NotImplementedError(
            f"the CUDA kernel {name} is not built for {key}={value}: {what}"
        )


_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}


def build_dir() -> Path:
    root = os.environ.get("OSQP_TORCH_BUILD_DIR")
    if root:
        return Path(root)
    return Path(__file__).resolve().parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str, signature: dict, host: bool, csrc: Path = CSRC):
    src = csrc / f"{name}.cu"
    h = hashlib.sha256()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    sig = "_".join(f"{k}{v}" for k, v in sorted(signature.items()))
    h.update(f"{sig}|{host}".encode())
    tag = "host_" if host else ""
    return src, build_dir() / f"{name}_{tag}{sig}_{h.hexdigest()[:12]}.so"


def _command(src: Path, out: Path, signature: dict, host: bool):
    defs = [f"-D{k}={v}" for k, v in sorted(signature.items())]
    if host:
        return [
            "g++", "-x", "c++", "-std=c++20", "-pthread", "-O1", "-shared",
            "-fPIC",
            "-DLANE_HOST_EMULATION", "-DLANE_REAL=double",
            *defs, "-o", str(out), str(src),
        ]
    return [_nvcc(), *_NVCC_FLAGS, *defs, "-o", str(out), str(src)]


def start_build(name: str, signature: dict, host: bool = False,
                csrc: Path = CSRC):
    """Start one compiler process (or none if the library exists) on
    ``csrc/<name>.cu`` (by default this package's sources).  Returns a
    handle for :func:`finish_build`."""
    check_limits(name, signature)
    src, out = _target(name, signature, host, Path(csrc))
    if out.exists():
        return (name, out, None, 0.0)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        _command(src, tmp, signature, host),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return (name, out, (proc, tmp), time.time())


def finish_build(handle) -> Path:
    name, out, running, t0 = handle
    if running is None:
        return out
    proc, tmp = running
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed (exit {proc.returncode}):\n{log}"
        )
    out.with_suffix(".log").write_text(
        log + f"\nbuild_seconds {time.time() - t0:.2f}\n"
    )
    os.replace(tmp, out)
    return out


def build_all(signatures, names=tuple(KERNELS)):
    """Build every kernel for every signature of its kind (the signature's
    keys are the kernel's :data:`KERNELS` entry), all compilers started
    together, one for each distinct (kernel, signature): two compilers of
    one target would write the same temporary file.  Returns ``{(name, sig
    items): path}``."""
    wanted = dict.fromkeys(
        (n, tuple(sorted(s.items())))
        for s in signatures for n in names if set(s) == set(KERNELS[n]))
    handles = [(n, s, start_build(n, dict(s))) for n, s in wanted]
    return {(n, s): finish_build(h) for n, s, h in handles}


def library(name: str, signature: dict, host: bool = False):
    """The loaded ``ctypes`` library of one kernel, built on first use."""
    key = (name, tuple(sorted(signature.items())), host)
    lib = _LIBS.get(key)
    if lib is None:
        path = finish_build(start_build(name, signature, host))
        lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib


def ptxas_report(path: Path) -> dict:
    """Registers, spill bytes and static shared memory per kernel from the
    saved ``-Xptxas -v`` output of one library (dynamic shared memory is
    set at launch)."""
    log = Path(path).with_suffix(".log")
    out = {}
    if not log.exists():
        return out
    text = log.read_text()
    blocks = re.split(r"Compiling entry function '([^']+)'", text)
    for fn, body in zip(blocks[1::2], blocks[2::2]):
        regs = re.search(r"Used (\d+) registers", body)
        st = re.search(r"(\d+) bytes spill stores", body)
        ld = re.search(r"(\d+) bytes spill loads", body)
        stack = re.search(r"(\d+) bytes stack frame", body)
        smem = re.search(r"(\d+) bytes smem", body)
        short = re.sub(r"^_Z\d+", "", fn)
        out[short] = {
            "registers": int(regs.group(1)) if regs else None,
            "stack_bytes": int(stack.group(1)) if stack else None,
            "spill_store_bytes": int(st.group(1)) if st else None,
            "spill_load_bytes": int(ld.group(1)) if ld else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
        }
    sec = re.search(r"build_seconds ([\d.]+)", text)
    if sec:
        out["build_seconds"] = float(sec.group(1))
    return out


# --------------------------------------------------------------- launching


def ptr(t) -> int:
    """Device pointer of a tensor as a Python int (``None`` → null)."""
    return None if t is None else t.data_ptr()


def stream(device):
    """PyTorch's current CUDA stream on ``device`` (null for a CPU device:
    the host-emulation build ignores it)."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
