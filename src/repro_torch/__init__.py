"""EJ-FAT load balancer in PyTorch, with hand-written CUDA kernels for the
NVIDIA H100 (sm_90a).

Mirrors the JAX package ``repro`` module for module (``core/``, ``data/``,
``kernels/``, ``controld/``, ``telemetry/``); the JAX package is the
reference each module is tested against. Every entry point takes an explicit
``device`` and defaults to ``"cuda"``: with no CUDA device it raises instead
of running on the CPU. Which implementation runs is decided by the device of
the tensors: a CUDA tensor launches the hand-written kernel, a CPU tensor
takes its plain PyTorch version (``kernels/ref.py``), as does a meta
tensor (the dry run, ``launch/dryrun.py``: shapes only).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
