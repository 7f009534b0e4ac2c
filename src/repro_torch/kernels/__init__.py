"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and behind one wrapper (``ops.py``)."""
