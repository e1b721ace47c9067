def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips without a "
        "card (run on the card: python -m pytest -m cuda tests/)")
