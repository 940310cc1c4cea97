"""gmix_tpu_torch: the gmix_tpu context-mixing codec ported to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A second package beside `gmix_tpu`, which stays the reference. This package
imports torch and never JAX or gmix_tpu; `config`, `core.meta` and
`ops.tables` are carried over from it field for field, so specs hash alike
and arenas line up. The codec (compress, decompress, temperature
sampling, checkpoints) runs on the CPU (plain torch) or on a CUDA device,
where the arena row movers and the 8 bit sub-steps are kernels (csrc/) built
with nvcc on first use. Importing the package builds nothing.

Archives are the same GXTC v4 container as gmix_tpu's, and the same bits on
the CPU and on a GPU: float32 matrix products run in full float32.
"""
import torch as _torch

# every float that reaches an archive is rounded in full float32
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (  # noqa: E402,F401
    EnsembleSpec,
    best_spec,
    reference_spec,
    scale_tables,
    tiny_spec,
)
from .core.codec import (  # noqa: E402,F401
    Predictor,
    compress_bytes,
    decompress_bytes,
    entropy_bits,
    generate_bytes,
)
from .parallel.mesh import broadcast_pretrained  # noqa: E402,F401
from .utils.serialization import (  # noqa: E402,F401
    CheckpointVersionError,
    copy_state,
    load_state,
    save_state,
)

__version__ = "0.1.0"
