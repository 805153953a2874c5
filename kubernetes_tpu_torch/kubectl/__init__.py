"""kubectl-equivalent CLI layer (ref: pkg/kubectl/).

Port of ``kubernetes_tpu/kubectl/__init__.py``.

The reference's CLI is a cobra command tree over a generic resource
Builder/Visitor pipeline (ref: pkg/kubectl/resource/builder.go:36) plus
per-kind printers and imperative helpers (resize, stop, rolling-update,
run, expose). The rebuild keeps the same layering:

- ``resource``        — Builder -> Info -> Visitor pipeline
- ``printers``        — human/json/yaml/template printers
- ``describe``        — per-kind describers
- ``generators``      — run-container and expose generators
- ``resize``/``stop``/``rolling_updater`` — imperative cluster surgery
- ``cmd``             — the argparse command tree (cobra equivalent)
"""

from kubernetes_tpu_torch.kubectl.cmd import KubectlError, main, run_kubectl  # noqa: F401
