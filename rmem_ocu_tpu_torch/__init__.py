"""rmem_ocu_tpu_torch: the PyTorch/CUDA port of rmem_ocu_tpu.

Restricted-memory video object segmentation (RMem, AOT/DeAOT lineage) on an
NVIDIA H100. Plain tensor code is PyTorch; the JAX package's Pallas kernels
are hand-written CUDA kernels under `csrc/`, built with nvcc at first use.
The port imports neither JAX nor the JAX package.
"""

from rmem_ocu_tpu_torch.config import get_config  # noqa: F401
from rmem_ocu_tpu_torch.engine.infer_engine import (  # noqa: F401
    EngineState,
    InferEngine,
)
from rmem_ocu_tpu_torch.models.vos_model import (  # noqa: F401
    VOSModel,
    build_vos_model,
)
