import os
import signal

# Tests run on the single real CPU device; ONLY the dry-run process forces
# 512 placeholder devices (see src/repro/launch/dryrun.py), and the
# `multidevice` subset expects the caller to export
# XLA_FLAGS=--xla_force_host_platform_device_count=8 (the CI multi-device
# job; see docs/scaling.md for the local recipe).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)

# watchdog for the producer/consumer suites: a deadlocked replay queue
# must fail the test fast, not hang the CI job (pytest-timeout is not in
# the image, so this is a harness-level SIGALRM guard)
ASYNC_RLHF_TIMEOUT_S = int(os.environ.get("ASYNC_RLHF_TIMEOUT_S", "900"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs >= 4 simulated devices "
        "(XLA_FLAGS=--xla_force_host_platform_device_count=8); "
        "skipped in the single-device tier-1 run")
    config.addinivalue_line(
        "markers",
        "async_rlhf: disaggregated async-RLHF suite (replay queue, "
        "producer/consumer threads); runs under a SIGALRM watchdog of "
        f"{ASYNC_RLHF_TIMEOUT_S}s so a deadlock fails fast "
        "(override with ASYNC_RLHF_TIMEOUT_S)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch/CUDA port's "
        "kernels); skipped where torch.cuda.is_available() is False")


def pytest_collection_modifyitems(config, items):
    if len(jax.devices()) >= 4:
        return
    skip = pytest.mark.skip(
        reason="needs >= 4 devices: run under "
               "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    for item in items:
        if "multidevice" in item.keywords:
            item.add_marker(skip)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if ("async_rlhf" not in item.keywords
            or not hasattr(signal, "SIGALRM")):
        yield
        return

    def _watchdog(signum, frame):
        raise TimeoutError(
            f"async_rlhf watchdog: {item.nodeid} exceeded "
            f"{ASYNC_RLHF_TIMEOUT_S}s — deadlocked queue/producer?")

    old = signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(ASYNC_RLHF_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
