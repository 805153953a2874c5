"""The port's WebSocket watch (v1 and v1beta1 frames), ``/debug/pprof``,
``/ui`` and kube-version-change (``cmd/version_change.py``) on the cases
of tests/test_websocket_pprof.py and tests/test_ui_and_tools.py. Left
out: the cases of binaries the port does not have yet
(``cmd/hyperkube.py``, the deploy scripts; ROADMAP Queue 1 item 15e)."""

import tracemalloc

import pytest

from test_torch_twin import port_twin

OTHER = "another binary of the reference (ROADMAP Queue 1 item 15e)"

globals().update(port_twin("test_websocket_pprof"))
globals().update(port_twin("test_ui_and_tools", {
    "test_hyperkube_knows_version_change": OTHER,
    "test_deploy_scripts_executable": OTHER,
}))


@pytest.fixture(autouse=True)
def _stop_tracemalloc():
    """``/debug/pprof/heap`` starts ``tracemalloc`` in this process and
    nothing stops it (as in the reference); stop it after each case, so
    the files this worker runs next do not run traced (ROADMAP Queue 3)."""
    tracing = tracemalloc.is_tracing()
    yield
    if not tracing:
        tracemalloc.stop()
