#!/usr/bin/env bash
# Bring up a local all-in-one cluster (ref: cluster/kube-up.sh + hack's
# local-up-cluster; the cloud provider scripts' slot — gce/aws/azure — is
# filled by the 'local' provider since this framework targets one host's
# accelerator, not cloud VMs).
#
# The port's copy of cluster/local-up.sh: the same flags, defaults
# and environment variables, starting the kubernetes_tpu_torch binaries
# (kubernetes_tpu_torch.cmd.standalone).
#
# Usage: kubernetes_tpu_torch/deploy/local-up.sh [port] [nodes]

set -euo pipefail
cd "$(dirname "$0")/../.."

PORT="${1:-8080}"
NODES="${2:-2}"

echo "Starting kubernetes-tpu standalone: apiserver :${PORT}, ${NODES} nodes"
echo "  dashboard: http://127.0.0.1:${PORT}/ui/"
echo "  kubectl:   python -m kubernetes_tpu_torch.cmd.hyperkube kubectl --namespace default get pods"
exec python -m kubernetes_tpu_torch.cmd.standalone --port "${PORT}" --nodes "${NODES}"
