#!/usr/bin/env bash
# kubectl CLI conformance of the port against a live apiserver (ref:
# hack/test-cmd.sh: the reference boots a local apiserver and walks
# kubectl through its verbs). Here: the port's CLI-facing suites, then
# the port's e2e driver's kubectl suite over real HTTP, with a kubeconfig
# built by the real config verbs, against the port's standalone cluster.
# Usage: [E2E_PORT=port] kubernetes_tpu_torch/tools/test-cmd.sh [pytest arguments]
# The standalone cluster listens on E2E_PORT, or on a free port.
set -euo pipefail
cd "$(dirname "$0")/../.."

python -m pytest tests/test_torch_kubectl.py tests/test_torch_clientauth.py \
    tests/test_torch_inventory_cloud.py -q "$@"
port="${E2E_PORT:-$(python -c 'import socket; s = socket.socket(); s.bind(("127.0.0.1", 0)); print(s.getsockname()[1])')}"
python -m kubernetes_tpu_torch.tools.e2e --up --port "$port" --focus kubectl
