"""PyTorch/CUDA port of ``retargetvid_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's layout (``config``, ``ops``, ``models``,
``pipeline``) and adds ``kernels``/``csrc`` for the hand-written CUDA
kernels that replace the JAX package's Pallas kernels.  It imports neither
JAX nor anything of ``retargetvid_tpu``; ``convert`` carries JAX parameter
trees (as numpy arrays) across.

Entry points take ``device=None`` and then run on ``cuda``; without a GPU
they raise unless the caller passes ``device="cpu"``.
"""

from retargetvid_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
