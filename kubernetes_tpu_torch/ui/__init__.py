"""Embedded web UI (ref: pkg/ui/datafile.go — go-bindata-embedded static
assets served at /static/; source under www/).

Port of ``kubernetes_tpu/ui/__init__.py``.

``asset(path)`` returns (bytes, content_type) for an embedded file; the
apiserver mounts the set at /ui/. The dashboard is a single self-contained
page polling the JSON API — the spiritual successor of www/app's cluster
view, small enough to embed as the reference embeds its build output.
"""

from kubernetes_tpu_torch.ui.datafile import ASSETS, asset  # noqa: F401
