"""megaverse_tpu_torch: the PyTorch/CUDA port of megaverse_tpu.

The JAX package `megaverse_tpu` is the reference; this package mirrors its
module layout (constants, types, env, vector_env, ops/, scenarios/, utils/)
so a reader finds each counterpart by name. It imports torch and numpy only.

- Worlds step in lockstep as plain batched tensor functions with an explicit
  leading env axis (where the JAX package uses jax.vmap).
- All agent views render in one launch of a hand-written CUDA kernel
  (ops/raycast_cuda.py, csrc/render.cu); observations stay on the device.
- Entry points run on the GPU unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from megaverse_tpu_torch.vector_env import VectorEnv  # noqa: F401
from megaverse_tpu_torch.scenarios import make_scenario, registered_scenarios  # noqa: F401
