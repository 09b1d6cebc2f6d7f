import os

# Tests and benches must see the real device topology (1 CPU device), never
# the dry-run's 512 placeholder devices. Multi-device tests spawn their own
# subprocess with XLA_FLAGS (tests/test_distributed.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# hypothesis is optional (repro.testing.hypo falls back to seeded random
# sampling); register the CI profile only when the real library is present.
try:
    from hypothesis import settings
except ImportError:
    pass
else:
    settings.register_profile("ci", max_examples=40, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch); "
                   "skips when torch.cuda.is_available() is False")
