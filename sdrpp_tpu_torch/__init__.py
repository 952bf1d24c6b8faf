"""sdrpp_tpu_torch — the sdrpp_tpu receive chain in PyTorch, for CUDA GPUs.

A port of the JAX package ``sdrpp_tpu`` (which stays the reference) with
the same module names and layout: ``ops`` (taps, FIR, resampling, mixing,
the channelizer, scans and the kernels' wrappers), ``models`` (RxVFO,
demodulators, RadioChannel, the Meteor chain), ``decoders``,
``parallel`` (the VFO/scanner bank and bench.py's bank chains), ``io``
(its own numpy-only WAV, source and sink modules), ``signal_path``,
``receiver`` and ``cli``. It imports nothing of ``sdrpp_tpu``. Blocks are
``(state, x) -> (state, y)`` callables over torch tensors; state is a
tree of tensors with the JAX state tree's keys and shapes.

The inner blocks take an explicit ``device``; the entry points
(``Receiver``, the decoders, ``ScannerBank``, the CLI) default to
``cuda`` and fail without a card. Every Pallas kernel of the JAX
package is a hand-written CUDA kernel here (``csrc/*.cu``: the loop scans,
the M&M, the Viterbi, the decimating FIR), launched on CUDA tensors;
on CPU tensors each wrapper runs its plain PyTorch version.

TF32 is switched off here, at import: cuDNN would otherwise run the
float32 strided convolutions of the decimators in TF32 (about three
decimal digits), and the port is held to the float32 reference.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
