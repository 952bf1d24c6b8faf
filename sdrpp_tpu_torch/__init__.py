"""sdrpp_tpu_torch — the sdrpp_tpu receive chain in PyTorch, for CUDA GPUs.

A port of the JAX package ``sdrpp_tpu`` (which stays the reference) with
the same module names and layout: ``ops`` (taps, FIR, resampling, mixing,
scans and the loop kernels), ``models`` (RxVFO, demodulators,
RadioChannel), ``signal_path``, ``receiver`` and ``cli``. Blocks are
``(state, x) -> (state, y)`` callables over torch tensors; state is a
tree of tensors with the JAX state tree's keys and shapes.

Every constructor takes an explicit ``device``. The per-sample loops (PLL,
AGC) run in the hand-written CUDA kernel ``csrc/loop_scan.cu`` on CUDA
tensors and in a plain PyTorch loop on CPU tensors.

TF32 is switched off here, at import: cuDNN would otherwise run the
float32 strided convolutions of the decimators in TF32 (about three
decimal digits), and the port is held to the float32 reference.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
