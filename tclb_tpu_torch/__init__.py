"""tclb_tpu_torch — the lattice-Boltzmann framework on PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``tclb_tpu``, module for
module: the same registry, the same planar data layout, the same XML
control plane.  Plain tensor code is PyTorch; the fused collide-stream
steps are CUDA kernels written by hand for Hopper (``csrc/``).  Entry points
run on the card unless the caller asks for the CPU.

This package imports nothing of ``tclb_tpu`` and nothing of JAX.
"""

__version__ = "0.2.0"

from tclb_tpu_torch.core.registry import ModelDef, Model  # noqa: F401
from tclb_tpu_torch.core.lattice import Lattice  # noqa: F401
from tclb_tpu_torch.models import get_model, list_models  # noqa: F401
