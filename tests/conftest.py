# NOTE: no XLA_FLAGS here on purpose — tests and benches must see ONE CPU
# device; only launch/dryrun.py forces 512 placeholder devices (and tests
# that need a mesh spawn a subprocess with their own flag).
import subprocess
import sys

import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401  (real package preferred when present)
except ImportError:
    import _hypothesis_fallback
    _hypothesis_fallback.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def run_subprocess(args, env, timeout=560, tag="SUBPROC_OK"):
    """Run a python subprocess oracle and assert it printed ``tag``.

    The shared harness for multi-device subprocess tests (sharded serving
    and chaos tests force their own ``--xla_force_host_platform_device_
    count``, so they cannot run in the pytest process).  Hardens the
    bare ``subprocess.run`` call sites: a hung child is killed at
    ``timeout`` and reported via ``pytest.fail`` with the tail of its
    partial output instead of surfacing as a raw ``TimeoutExpired``
    stack (or, without a timeout, hanging the whole suite until CI's
    global kill).
    """
    try:
        proc = subprocess.run([sys.executable, *args], capture_output=True,
                              text=True, env=env, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"")
        out = out.decode(errors="replace") if isinstance(out, bytes) else out
        pytest.fail(f"subprocess timed out after {timeout}s; partial "
                    f"output tail:\n{out[-2000:]}", pytrace=False)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert tag in proc.stdout, proc.stdout
    return proc
