#!/usr/bin/env bash
# Bring up the control plane as SEPARATE processes — apiserver,
# controller-manager, scheduler, one kubelet — wired only through HTTP,
# the way the reference deploys its binaries (ref: cluster/saltbase
# service layout). Ctrl-C tears everything down.
#
# KTPU_DATA_DIR=<dir> makes the cluster CRASH-DURABLE
# (docs/design/ha.md): a kube-store process owns a DurableStore
# (WAL + snapshots) on that directory and the apiserver speaks to it
# over --store-server — kill any process, restart the stack on the same
# dir, and the cluster resumes with its resourceVersions intact. Empty
# keeps the historical in-memory in-process store.
#
# The port's copy of cluster/multi-process-up.sh: the same flags, defaults
# and environment variables, starting the kubernetes_tpu_torch
# binaries (the kubelets' root directories go under $TMPDIR when it
# is set).
#
# Usage: kubernetes_tpu_torch/deploy/multi-process-up.sh [port]

set -euo pipefail
cd "$(dirname "$0")/../.."

PORT="${1:-8080}"
MASTER="http://127.0.0.1:${PORT}"
PIDS=()
cleanup() { kill "${PIDS[@]}" 2>/dev/null || true; }
trap cleanup EXIT INT TERM

SOLVERD_PORT="${SOLVERD_PORT:-10450}"
KTPU_DATA_DIR="${KTPU_DATA_DIR:-}"
STORE_PORT="${STORE_PORT:-2379}"
STORE_METRICS_PORT="${STORE_METRICS_PORT:-10460}"

if [[ -n "${KTPU_DATA_DIR}" ]]; then
    mkdir -p "${KTPU_DATA_DIR}"
    python -m kubernetes_tpu_torch.cmd.storeserver --port "${STORE_PORT}" \
        --data-dir "${KTPU_DATA_DIR}" \
        --metrics-port "${STORE_METRICS_PORT}" &
    PIDS+=($!)
    # the store must answer before the apiserver's first list
    for _ in $(seq 1 60); do
        if (exec 3<>"/dev/tcp/127.0.0.1/${STORE_PORT}") 2>/dev/null; then
            exec 3>&- 3<&-
            break
        fi
        sleep 0.5
    done
    python -m kubernetes_tpu_torch.cmd.apiserver --port "${PORT}" \
        --store-server "127.0.0.1:${STORE_PORT}" &
else
    python -m kubernetes_tpu_torch.cmd.apiserver --port "${PORT}" &
fi
PIDS+=($!)
sleep 1
python -m kubernetes_tpu_torch.cmd.controller_manager --master "${MASTER}" &
PIDS+=($!)
# the shared solver daemon: every tpu-batch scheduler worker points at it
# (waves coalesce into batched solves in one hot runtime); schedulers fall
# back to in-process solving automatically if it dies
python -m kubernetes_tpu_torch.cmd.solverd --port "${SOLVERD_PORT}" &
PIDS+=($!)
# the daemon must own its socket before the scheduler's first wave, or
# the RemoteSolver starts out in its unhealthy-fallback cooldown
for _ in $(seq 1 60); do
    if (exec 3<>"/dev/tcp/127.0.0.1/${SOLVERD_PORT}") 2>/dev/null; then
        exec 3>&- 3<&-
        break
    fi
    sleep 0.5
done
python -m kubernetes_tpu_torch.cmd.scheduler --master "${MASTER}" \
    --algorithm tpu-batch --solver-addr "127.0.0.1:${SOLVERD_PORT}" &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.kubelet --api-servers "${MASTER}" \
    --hostname-override "$(hostname)" --register-node --port 10250 \
    --root-dir "${TMPDIR:-/tmp}/kubelet-tpu" &
PIDS+=($!)
# addons (ref: cluster/addons/{dns,cluster-monitoring,fluentd-elasticsearch})
python -m kubernetes_tpu_torch.cmd.dns --master "${MASTER}" --port 10053 &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.monitoring --master "${MASTER}" --port 10251 &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.logging --master "${MASTER}" --port 10252 &
PIDS+=($!)

echo "control plane up: ${MASTER} (Ctrl-C to stop)"
echo "  solverd:    tcp://127.0.0.1:${SOLVERD_PORT}  (shared wave solver)"
echo "  dns:        udp://127.0.0.1:10053  (<svc>.<ns>.cluster.local)"
echo "  monitoring: http://127.0.0.1:10251/api/v1/model"
echo "  logging:    http://127.0.0.1:10252/logs?namespace=default"
wait
