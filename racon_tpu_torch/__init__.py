"""racon_tpu_torch: racon-style consensus polishing in PyTorch, with
hand-written CUDA kernels for the H100 (Hopper, sm_90a).

The port of the JAX package `racon_tpu`, beside it in the repository. It
imports nothing of `racon_tpu` and never loads JAX: the host modules it
needs (parsers, records, the C++ host library) are its own copies.

Main path: `python -m racon_tpu_torch reads overlaps target > out.fa`
(contig polishing), with overlap alignment (csrc/align_wavefront.cu) and
POA consensus (csrc/poa_window_sweep.cu) on the GPU.
"""

__version__ = "0.1.0"
