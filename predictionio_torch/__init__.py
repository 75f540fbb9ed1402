"""predictionio_torch — the PyTorch/CUDA port of predictionio_tpu.

The JAX package ``predictionio_tpu`` is the reference this package is
tested against; the port imports none of it and never imports JAX. Module
names mirror the reference's, so each module's counterpart is found by
path (``predictionio_torch/ops/als.py`` ↔ ``predictionio_tpu/ops/als.py``).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"`` or ``PIO_TORCH_DEVICE=cpu``); see ``device.py``.
"""

import torch

__version__ = "0.1.0"

# The reference runs its f32 solve math at HIGHEST precision
# (ops/pallas_solve.py::_schur_rec): keep every f32 matmul and convolution
# of the port in full f32 instead of TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
