"""kubectl binary (ref: cmd/kubectl/kubectl.go — delegates to the cmd
tree).

Port of ``kubernetes_tpu/cmd/kubectl.py``."""

from __future__ import annotations

import sys

from kubernetes_tpu_torch.kubectl.cmd import main as kubectl_main

__all__ = ["main"]


def main() -> int:
    return kubectl_main()


if __name__ == "__main__":
    sys.exit(main())
