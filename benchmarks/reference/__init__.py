"""Plain references the benchmark judges the program against.

Nothing here imports the program (`megaverse_tpu_torch`), the JAX package or
JAX: `sim/` is a frozen copy of the port's plain PyTorch/NumPy code (the
scenarios' layout generators, the sim step, the table renderer) with every
native or CUDA path removed, `policy.py` the actor-critic and its PPO update
written out in plain torch, `roofline.py` and `flops.py` the work the
configurations need.
"""
