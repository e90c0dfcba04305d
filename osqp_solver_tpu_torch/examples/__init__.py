"""The JAX package's five example applications as the port's own entry
points (``examples/*.py`` there), each run as
``python -m osqp_solver_tpu_torch.examples.<name>`` or through its
``main(argv)``: on the CUDA device unless ``--cpu`` is given, with no
fallback to the CPU.  Every CUDA kernel of the port takes float32 only, so
each example solves in float32 on the card; under ``--cpu`` it keeps the JAX
script's default dtype.  Importing a module here runs nothing."""
