"""MVP-Benchmark on PyTorch and CUDA: the port of ``mvp_benchmark_tpu``.

The JAX package beside this one is the reference each module here is held
against (``tests/test_torch_*.py``). The layout and module names mirror it:

- ``mvp_benchmark_tpu_torch.ops``     -- geometry ops: a plain PyTorch version
  of each op (``ops/ref.py``) and a CUDA kernel written for Hopper for each
  Pallas kernel of the JAX package (``ops/csrc``, bound in ``ops/kernels.py``),
  chosen by the tensor's device in ``ops/dispatch.py``.
- ``mvp_benchmark_tpu_torch.metrics`` -- CD (cd_p / cd_t / F1, EMD) and the
  registration metrics.
- ``mvp_benchmark_tpu_torch.models``  -- the ported models (PCN, ECG, VRCNet,
  DCP) and the parameter transplant from the JAX models.
- ``mvp_benchmark_tpu_torch.data``    -- MVP completion and registration
  loaders with the same synthetic fallback as the JAX package.
- ``mvp_benchmark_tpu_torch.train``   -- config, checkpoints, eval loop,
  submission writer.

This package imports ``torch`` and never ``jax`` or ``flax``.
"""

import torch

__version__ = "0.1.0"

# fp32 stays fp32 on the card: a float32 matmul or convolution must not round
# its inputs to TF32 behind the caller's back.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# and a bf16 matmul accumulates in fp32, as the JAX package's Dense layers ask
# (preferred_element_type), without cuBLAS's reduced-precision reductions.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
