"""Kernels of the port and their plain PyTorch versions.  On a CUDA
tensor each wrapper launches its kernel (or raises); on a CPU tensor it
runs the plain version."""
