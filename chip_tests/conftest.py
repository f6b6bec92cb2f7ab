"""On-card test configuration.

Unlike ``tests/`` (which pins the CPU backend for the full oracle
matrix), these tests run on the GPU JAX finds.  Tests that need the card
carry the ``chip`` marker; the autouse fixture below skips them, with a
reason, when the backend is not a GPU.  The decision is taken inside the
fixture, at run time, so every pytest worker collects the same tests.

Run with:  python chip_smoke.py   (runs this directory in its process)
"""

import pytest


@pytest.fixture(autouse=True)
def _require_gpu(request):
    if request.node.get_closest_marker("chip") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            f"needs a GPU; JAX backend is {jax.default_backend()!r}"
        )
