def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (runs the hand-written kernels); skips without one",
    )
