#!/usr/bin/env bash
# Concurrency stress sweep of the port (the KUBE_RACE analog, ref:
# hack/test-go.sh:50): runs kubernetes_tpu_torch/tools/stress.py under
# maximal thread interleaving against both scheduler paths, the tpu-batch
# waves solving on DEVICE (cuda by default, which needs a card; cpu runs
# the kernel's plain version).
# Usage: kubernetes_tpu_torch/tools/stress.sh [seconds-per-run] [device]
set -euo pipefail
cd "$(dirname "$0")/../.."
SECONDS_PER_RUN="${1:-20}"
DEVICE="${2:-cuda}"
echo "== stress: serial scheduler (${SECONDS_PER_RUN}s) =="
python -m kubernetes_tpu_torch.tools.stress --seconds "$SECONDS_PER_RUN"
echo "== stress: tpu-batch scheduler on ${DEVICE} (${SECONDS_PER_RUN}s) =="
python -m kubernetes_tpu_torch.tools.stress --seconds "$SECONDS_PER_RUN" \
    --batch --device "$DEVICE"
echo "stress sweep CLEAN"
