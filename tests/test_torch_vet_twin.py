"""tests/test_vet.py against the port's kube-vet and locksmith. The
rules' path fixtures (``kubernetes_tpu/…``) are read as the port's
(``kubernetes_tpu_torch/…``), so each rule scoped to the package runs on
port paths (the donation-safety check of the committed mesh executor reads
the port's ``solver/mesh_exec.py`` and ``parallel/mesh.py``), and the CLI
is the port's ``tools/vet.py``.

Every case runs. The PEP 701 f-string case passes here because the port's
``py310-compat`` rule also walks the tokens on Python >= 3.12, where
``ast.parse(feature_version=(3, 10))`` accepts the nested form; the
reference's rule does not, and its own case fails on such a Python."""

from test_torch_twin import port_twin

globals().update(port_twin(
    "test_vet", paths=True,
    rename={'"hack/vet.py"': '"kubernetes_tpu_torch/tools/vet.py"'}))
