"""Hand-written Hopper kernels of the port and their plain versions.

  netkv_score_cohort  Algorithm 1 scoring and the first two (cost, index)
                      minima, a cluster of blocks a row (csrc/netkv_score.cu)
  kv_pack / kv_unpack paged-KV gather into a transfer buffer and its inverse
                      scatter (csrc/kv_pack.cu)
  flash_decode        GQA one-token attention with an online softmax
                      (csrc/flash_decode.cu)
  waterfill_progressive / waterfill_fast
                      max-min water-filling fixed points, progressive (with
                      the bottleneck trace) and parallel-bottleneck
                      (csrc/waterfill.cu)
  rwkv_scan           the WKV-6 recurrence of the RWKV-6 time mix, one block
                      per (batch, head) over the whole of T (csrc/rwkv_scan.cu)
  moe_decode          a decode step's MoE FFN over the experts its tokens
                      route to, reading no other expert (csrc/moe_decode.cu)
  moe_route           a decode step's MoE routing and capacity rule: top k,
                      kept gates and aux loss in one launch of one
                      8-block cluster (csrc/moe_route.cu)

``ops`` routes CUDA tensors to the kernels and CPU tensors to ``ref``;
``build`` compiles the sources with nvcc at first use and counts launches.
"""

from . import build, ops, ref

__all__ = ["build", "ops", "ref"]
