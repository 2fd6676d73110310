"""hpmvs_tpu_torch: progressive prioritized multi-view stereo on PyTorch/CUDA.

The PyTorch port of hpmvs_tpu (the JAX package beside it, which stays the
reference): sparse SfM (NVM) -> progressively densified oriented patch cloud
via prioritized coarse-to-fine octree expansion, with batched NCC
photoconsistency refinement in hand-written CUDA kernels (csrc/) on an
NVIDIA Hopper GPU. Every kernel has a plain PyTorch twin that runs for CPU
tensors. This package never imports jax or hpmvs_tpu.
"""

import torch

from hpmvs_tpu_torch.config import DEFAULT, Options  # noqa: F401

__version__ = "0.1.0"

# the NCC contractions and projections must stay full fp32 on the GPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks for
    the CPU. Raises RuntimeError when a CUDA device is asked for and none is
    visible -- there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hpmvs_tpu_torch needs an NVIDIA GPU, and torch sees no CUDA "
            "device; pass device=\"cpu\" (CLI: --device cpu) to run on the "
            "CPU")
    return dev
