"""The benchmark's own tests: ``python -m pytest bench_gpu/tests`` from the
root of the repo. Tests that need the card carry the ``card`` marker and
decide inside the test whether there is one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one (decided inside the test)")
