from pathlib import Path

import pytest

# The JAX package's adjoint self-test takes ~1,400 s of one worker, most of
# tier-1's limit; tier-1 (-m 'not slow') leaves it out, and the port's
# adjoint stays there in tests/test_torch_adjoint*.py.
_SLOW = Path(__file__).parent / "tests" / "test_adjoint.py"


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.path == _SLOW:
            item.add_marker(pytest.mark.slow)
