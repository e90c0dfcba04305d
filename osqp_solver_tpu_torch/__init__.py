"""PyTorch/CUDA port of the batched ADMM QP solver + GOMP trajectory stack.

The JAX package ``osqp_solver_tpu`` is the reference; this package mirrors
its sub-packages (``ops``, ``gomp``, ``models``) module for module, imports
``torch`` and numpy only, and runs on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``csrc/``).  Every entry point takes an explicit
``device``; the default is ``"cuda"`` and CPU execution (through the plain
PyTorch versions of the kernels) must be requested with ``device="cpu"``.
"""

__all__ = ["ops", "gomp", "models", "convert"]
