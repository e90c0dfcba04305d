"""What the example drivers share: the device and dtype rule, and the wall
clock around a call that runs on the device."""
from __future__ import annotations

import time

import torch

from ..ops.admm import resolve_device


def device_and_dtype(cpu: bool, f32: bool = False, f64: bool = False):
    """``(device, dtype)`` of an example: the CUDA device unless ``cpu``
    (no fallback: without a card this raises), float32 on the card (the
    kernels take nothing else; ``f64`` asks for float64 there and gets the
    kernels' ``TypeError``), the JAX script's float64 on the CPU unless
    ``f32``."""
    device = resolve_device("cpu" if cpu else "cuda")
    if device.type == "cuda":
        return device, torch.float64 if f64 else torch.float32
    return device, torch.float32 if f32 else torch.float64


def timed(device, fn, *args, **kw):
    """``(fn(*args, **kw), seconds)``, the device synchronized after."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0
