"""The port's WebSocket watch (v1 and v1beta1 frames), ``/debug/pprof``,
``/ui``, kube-version-change (``cmd/version_change.py``), hyperkube's
table and the deploy scripts on the cases of
tests/test_websocket_pprof.py and tests/test_ui_and_tools.py. The deploy
scripts' case reads the reference's two ``cluster/`` scripts as the
port's own copies under ``kubernetes_tpu_torch/deploy/``; its ``hack/``
scripts stay as they are. No case is left out."""

import tracemalloc

import pytest

from test_torch_twin import port_twin

globals().update(port_twin("test_websocket_pprof"))
globals().update(port_twin("test_ui_and_tools", rename={
    '"cluster/local-up.sh"': '"kubernetes_tpu_torch/deploy/local-up.sh"',
    '"cluster/multi-process-up.sh"':
        '"kubernetes_tpu_torch/deploy/multi-process-up.sh"',
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
