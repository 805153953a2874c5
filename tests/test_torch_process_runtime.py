"""The port's process runtime (kubelet/process_runtime.py) and in-process
cluster (cluster.py) on every case of tests/test_process_runtime.py: pods
as local process groups under the pause sandbox, logs, exec, stop by
process group, restarts, the Python sandbox fallback, and a cluster of
process-runtime kubelets. The port builds the native pause binary into
its own gitignored ``kubelet/_build/``, never into ``native/``."""

from test_torch_twin import port_twin

globals().update(port_twin("test_process_runtime"))


def test_pause_binary_is_built_outside_native():
    """Without a binary in native/pause/, the port builds pause.cc into
    ``kubelet/_build/`` under a name keyed by the source's hash (or takes
    the Python sandbox where there is no ``g++``), and writes nothing
    into native/."""
    import os
    import shutil

    from kubernetes_tpu_torch.kubelet import process_runtime as pr
    native = os.path.join(pr._REPO_ROOT, "native", "pause")
    before = sorted(os.listdir(native))
    got = pr.find_pause_binary()
    assert sorted(os.listdir(native)) == before
    if os.path.isfile(os.path.join(native, "pause")):
        assert got == os.path.join(native, "pause")
    elif shutil.which("g++"):
        assert os.path.dirname(got) == pr.BUILD_DIR
        assert os.path.basename(got).startswith("pause-")
        assert os.access(got, os.X_OK)
        assert pr.find_pause_binary() == got
    else:
        assert got == os.path.join(native, "pause.py")
