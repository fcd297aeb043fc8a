"""Hand-written Hopper kernels, one package each: ``ref.py`` (plain PyTorch),
``kernel.py`` (build + launch), ``ops.py`` (the dispatcher models call)."""
