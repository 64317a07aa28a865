"""Settings of the benchmark's own tests: the ``cuda`` marker (tests
that need an NVIDIA card skip themselves without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
