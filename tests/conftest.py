import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device. Multi-device tests spawn subprocesses.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips itself where "
        "torch.cuda.is_available() is false")
