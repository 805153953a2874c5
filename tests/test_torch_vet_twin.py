"""tests/test_vet.py against the port's kube-vet and locksmith. The
rules' path fixtures (``kubernetes_tpu/…``) are read as the port's
(``kubernetes_tpu_torch/…``), so each rule scoped to the package runs on
port paths (the donation-safety check of the committed mesh executor reads
the port's ``solver/mesh_exec.py`` and ``parallel/mesh.py``), and the CLI
is the port's ``tools/vet.py``.

Left out: the PEP 701 f-string case, which fails the same way against the
reference on this Python (ROADMAP, "JAX-side failures")."""

from test_torch_twin import port_twin

globals().update(port_twin("test_vet", {
    "TestPy310Compat::test_pr1_fstring_form_flagged":
        "Python 3.12 parses the PEP 701 form under feature_version=(3, 10); "
        "the reference's case fails the same way",
}, paths=True, rename={'"hack/vet.py"': '"kubernetes_tpu_torch/tools/vet.py"'}))
