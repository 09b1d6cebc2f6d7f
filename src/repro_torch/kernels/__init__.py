"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions
(``ref.py``). Importing this package builds nothing: the library is built
and loaded at the first launch on a CUDA tensor (``_lib.lib``)."""
