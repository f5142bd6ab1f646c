"""The paper's ACE sketch in PyTorch: SRP hashing (``srp``, with the SRHT
family in ``srht``), the count
arrays and their statistics (``sketch``), the estimators (``estimators``),
and the carry-over of JAX-package state (``convert``)."""
