"""Hand-written CUDA kernels for Hopper (``csrc/``), their PyTorch
wrappers, and the sketch-level ``ops`` over them.

Each wrapper module (``srp_hash``, ``ace_update``, ``ace_query``,
``ace_admit_fused``) holds the kernel's binding with its launch counter
(``KERNEL.launches``) and a plain PyTorch version (``*_plain``) that the
wrapper takes only for CPU tensors.  ``build`` compiles and loads the
CUDA sources on first use.
"""
