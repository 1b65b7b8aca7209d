"""Hand-written Hopper kernels of the port and their plain versions.

  netkv_score_cohort  Algorithm 1 scoring + masked argmin (csrc/netkv_score.cu)
  kv_pack / kv_unpack paged-KV gather into a transfer buffer and its inverse
                      scatter (csrc/kv_pack.cu)
  flash_decode        GQA one-token attention with an online softmax
                      (csrc/flash_decode.cu)

``ops`` routes CUDA tensors to the kernels and CPU tensors to ``ref``;
``build`` compiles the sources with nvcc at first use and counts launches.
"""

from . import build, ops, ref

__all__ = ["build", "ops", "ref"]
