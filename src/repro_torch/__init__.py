"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (sm_90a).

Module paths mirror ``repro``'s.  The port imports neither ``jax`` nor
``repro``; entry points run on the card unless the caller passes
``device="cpu"``.
"""
