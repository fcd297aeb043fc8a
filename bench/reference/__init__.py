"""Plain PyTorch references, one module per model family, named by each configuration's ``reference``."""
