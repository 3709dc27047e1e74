"""Hand-written Hopper kernels of the port, one package per kernel: the
CUDA source, ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper that launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor)."""
