"""PyTorch/CUDA port of mlis_tpu for an NVIDIA H100.

The package mirrors ``mlis_tpu``'s layout (``ops/``, ``models/``,
``gating/``) and imports neither JAX nor anything of ``mlis_tpu``. Plain
tensor code is PyTorch; each kernel that ``mlis_tpu`` wrote in Pallas is a
hand-written CUDA kernel under ``csrc/``, built on first use by
:mod:`mlis_tpu_torch._build`. Entry points take a ``device`` argument that
defaults to ``"cuda"``; on CPU tensors each kernel wrapper runs its plain
PyTorch version.
"""
