"""Hand-written CUDA kernels for Hopper (``csrc/``), their PyTorch
wrappers, and the sketch-level ``ops`` over them.

Each wrapper module (``srp_hash``, ``srht_hash``, ``ace_update``,
``ace_query``, ``ace_score_fused``, ``ace_admit_fused``,
``ace_window_combine``, ``ace_fleet_score``, ``ace_fleet_window_admit``)
holds the kernel's binding with its launch counter
(``KERNEL.launches``) and a plain PyTorch version (``*_plain``) that the
wrapper takes only for CPU tensors.  ``build`` compiles and loads the
CUDA sources on first use.
"""
