"""kube-defrag — the descheduler subsystem.

Continuous consolidation waves over the dense preemption machinery:
``models/defrag.py`` holds the pure solve (score, candidate selection,
dense migration plan), this package's controller runs it as a background
wave loop against the API server and commits accepted moves atomically
through the Binding migration path (``from_host`` + ``pod_uid`` guarded
evict-here + bind-there). ``cmd/descheduler.py`` is the binary.

Port of ``kubernetes_tpu/descheduler/__init__.py``.
"""

from kubernetes_tpu_torch.descheduler.controller import (Descheduler,
                                                   DeschedulerConfig,
                                                   WaveReport)

__all__ = ["Descheduler", "DeschedulerConfig", "WaveReport"]
