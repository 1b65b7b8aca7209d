"""repro_torch: the PyTorch/CUDA port of the NetKV reproduction.

It imports nothing of JAX and nothing of the JAX package ``repro``; the
NumPy modules it needs are its own copies.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
