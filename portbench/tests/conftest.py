def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips without one (decided inside the "
        "test)")
