"""The port's WebSocket watch, ``/debug/pprof`` and ``/ui`` on the cases
of tests/test_websocket_pprof.py and tests/test_ui_and_tools.py that
cover the apiserver. Left out: the v1beta1 frames (the legacy wire,
ROADMAP Queue 1 item 13) and the cases of other binaries
(``cmd/version_change.py``, ``cmd/hyperkube.py``, the deploy scripts;
Queue 1 item 15)."""

import tracemalloc

import pytest

from test_torch_twin import port_twin

OTHER = "another binary of the reference (ROADMAP Queue 1 item 15)"

globals().update(port_twin("test_websocket_pprof", {
    "test_websocket_watch_v1beta1_frames":
        "the legacy v1beta1 wire is not ported (Queue 1 item 13)",
}))
globals().update(port_twin("test_ui_and_tools", {
    "test_version_change_round_trip": OTHER,
    "test_version_change_bad_input": OTHER,
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
