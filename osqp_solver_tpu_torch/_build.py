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
mode (``-std=c++20 -pthread -DLANE_HOST_EMULATION -DLANE_REAL=double``: a
cooperative launch runs each block's threads as fibers of the calling
thread, switched at every barrier), which lets a test check a kernel's
arithmetic, in double, without a GPU; :func:`float_library` builds them in
float with the card's warp of 32: their plan functions plan as on a card of
a given shared memory and SM count, and their kernels run the card's
arithmetic in float.  The solver never takes either path.
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


# Host emulation's build modes: the defines that set them (``None``: the
# card's build with nvcc).  In double (the tests' checks of a kernel's
# arithmetic); :func:`float_library` adds the float mode.
HOST = {"LANE_REAL": "double"}


def _float_mode(smem: int, sms: int) -> dict:
    """Host emulation in float with the card's warp of 32, planning as on a
    card whose blocks may use ``smem`` bytes of shared memory and which has
    ``sms`` SMs."""
    return {"LANE_REAL": "float", "LANE_EMU_WARP": 32,
            "LANE_EMU_SMEM": int(smem), "LANE_EMU_SMS": int(sms)}


def _target(name: str, signature: dict, mode, csrc: Path = CSRC):
    """The source and library path of one build (``mode``: as
    :data:`HOST`)."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    sig = "_".join(f"{k}{v}" for k, v in sorted(signature.items()))
    if mode is None or mode == HOST:
        h.update(f"{sig}|{mode is not None}".encode())
        tag = "" if mode is None else "host_"
    else:
        h.update(f"{sig}|{sorted(mode.items())}".encode())
        tag = "float_"
    return src, build_dir() / f"{name}_{tag}{sig}_{h.hexdigest()[:12]}.so"


def _command(src: Path, out: Path, signature: dict, mode):
    defs = [f"-D{k}={v}" for k, v in sorted(signature.items())]
    if mode is not None:
        return [
            "g++", "-x", "c++", "-std=c++20", "-pthread", "-O1", "-shared",
            "-fPIC", "-DLANE_HOST_EMULATION",
            *[f"-D{k}={v}" for k, v in mode.items()],
            *defs, "-o", str(out), str(src),
        ]
    return [_nvcc(), *_NVCC_FLAGS, *defs, "-o", str(out), str(src)]


def start_build(name: str, signature: dict, host: bool = False,
                csrc: Path = CSRC):
    """Start one compiler process (or none if the library exists) on
    ``csrc/<name>.cu`` (by default this package's sources), for the card
    or, with ``host``, in host emulation in double.  Returns a handle for
    :func:`finish_build`."""
    return _start(name, signature, HOST if host else None, Path(csrc))


def _start(name: str, signature: dict, mode, csrc: Path):
    src, out = _target(name, signature, mode, csrc)
    if out.exists():
        return (name, out, None, 0.0)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        _command(src, tmp, signature, mode),
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
    # The compiler's own time: its output's last write (builds started
    # together are finished one after the other here).
    out.with_suffix(".log").write_text(
        log + f"\nbuild_seconds {tmp.stat().st_mtime - t0:.2f}\n"
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


def _load(path: Path, signature: dict):
    """Load a built library, noting whether its signature gives its lane
    kernels their wide forms (2N or B2 above 32: see :func:`wide`)."""
    lib = ctypes.CDLL(str(path))
    size = (2 * signature["NDIM"] if "NDIM" in signature
            else signature.get("B2"))
    if size is not None:
        lib._osqp_wide = int(size) > 32
    return lib


def library(name: str, signature: dict, host: bool = False):
    """The loaded ``ctypes`` library of one kernel, built on first use."""
    key = (name, tuple(sorted(signature.items())), host)
    lib = _LIBS.get(key)
    if lib is None:
        path = finish_build(start_build(name, signature, host))
        lib = _LIBS[key] = _load(path, signature)
    return lib


def start_float_build(name: str, signature: dict, smem: int, sms: int):
    """:func:`start_build` of :func:`float_library`'s build."""
    return _start(name, signature, _float_mode(smem, sms), CSRC)


def float_library(name: str, signature: dict, smem: int, sms: int):
    """``csrc/<name>.cu`` built with ``g++`` in float with the card's warp
    of 32 (host emulation otherwise) for a card whose blocks may use
    ``smem`` bytes of shared memory and which has ``sms`` SMs: its plans,
    and the bytes in them, are that card's, and its kernels run the card's
    arithmetic in float, each product and sum rounded on its own (no fused
    multiply-add).  A launch has the emulated store (512 KB) alone."""
    key = (name, tuple(sorted(signature.items())), "float", smem, sms)
    lib = _LIBS.get(key)
    if lib is None:
        path = finish_build(start_float_build(name, signature, smem, sms))
        lib = _LIBS[key] = _load(path, signature)
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


def wide(lib, group_of) -> bool:
    """Whether ``lib`` is a wide build (above 16 joints: a group of several
    warps a problem, whose plans may ask for a device-memory workspace),
    from the signature it was loaded for (:func:`library`), else read once
    from ``group_of(lib)``, its plan's group (above 32 threads)."""
    w = getattr(lib, "_osqp_wide", None)
    if w is None:
        w = lib._osqp_wide = int(group_of(lib)) > 32
    return w


# The most threads a problem's group takes (``LANE_GROUP_MAX`` of
# ``csrc/lane_platform.cuh``): with as many producer threads a block's
# 1,024; above it a thread owns several columns of its problem.
GROUP_MAX = 512
# The shared memory a block may use on an H100.  The refusals that come
# before any build (:func:`.ops.admm_lane.check_kernel_limits`,
# ``tridiag_kernel._lib``) hold a size to it; the plans that launch read
# the device's own.
CARD_SHARED_BYTES = 232448


def group_size(n: int, least: int = 1) -> int:
    """The group of threads of a problem of ``n`` columns, as
    ``group_size`` of ``csrc/lane_platform.cuh`` sizes it: the smallest
    power of two >= ``n``, at least ``least``, at most :data:`GROUP_MAX`."""
    return min(max(least, 1 << max(n - 1, 0).bit_length()), GROUP_MAX)


def workspace(nbytes: int, device):
    """A device-memory workspace of ``nbytes`` for a launch whose plan puts
    rows off chip (the wide forms' rings and windows), or ``None`` where
    the plan needs none."""
    if nbytes <= 0:
        return None
    return torch.empty(int(nbytes), dtype=torch.uint8, device=device)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaGetLastError``, or
    -1: its plan refused the launch (it does not fit the device's shared
    memory, a workspace is missing, or a size is out of range)."""
    if err == -1:
        raise RuntimeError(f"{what}: refused by its launch plan (it does not "
                           "fit the device's shared memory, a workspace is "
                           "missing, or a size is out of range)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
