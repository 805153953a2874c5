#!/usr/bin/env bash
# Provider-driven cluster bring-up (ref: cluster/kube-up.sh — the
# reference reads a cloud provider's config and provisions master +
# minions; here the provider seam does the discovery and the components
# come up one process per instance, DESIGN.md-style).
#
# Reads a cloud inventory (the "inventory" provider's JSON: zone +
# instances, each with a DISTINCT loopback address and optional
# cpu/memory capacity), then launches:
#   - kube-store + apiserver (SO_REUSEPORT-ready) with
#     --cloud-provider inventory
#   - controller-manager with --cloud-provider inventory, which
#     registers every discovered instance as a Node (capacity and
#     addresses from the inventory, zone from the Zones facet)
#   - scheduler (tpu-batch), one kubelet PER INSTANCE bound to that
#     instance's address on the STANDARD kubelet port — so the
#     monitoring/logging addons and the apiserver's node proxy reach
#     each node at <address>:10250 exactly like a real fleet
#   - the dns/monitoring/logging addons.
#
# The port's copy of cluster/inventory-up.sh: the same flags, defaults
# and environment variables, starting the kubernetes_tpu_torch
# binaries (the kubelets' root directories go under $TMPDIR when it
# is set).
#
# Usage: kubernetes_tpu_torch/deploy/inventory-up.sh inventory.json [port]
# Inventory example (distinct 127/8 loopback addresses):
#   {"zone": {"failure_domain": "cell-a", "region": "local"},
#    "instances": [
#      {"name": "node-a", "addresses": ["127.0.1.1"], "cpu": "8",
#       "memory": "16Gi"},
#      {"name": "node-b", "addresses": ["127.0.1.2"], "cpu": "8",
#       "memory": "16Gi"}]}

set -euo pipefail
INVENTORY="$(realpath "${1:?usage: kubernetes_tpu_torch/deploy/inventory-up.sh inventory.json [port]}")"
cd "$(dirname "$0")/../.."

PORT="${2:-8080}"
STORE_PORT=$((PORT + 1))
MASTER="http://127.0.0.1:${PORT}"
PIDS=()
trap 'kill "${PIDS[@]}" 2>/dev/null || true' EXIT INT TERM

# name:address pairs up front — fail fast on a malformed inventory
PAIRS=$(python - "$INVENTORY" <<'EOF'
import json, sys
data = json.load(open(sys.argv[1]))
for inst in data["instances"]:
    addrs = inst.get("addresses") or []
    if not addrs:
        sys.exit(f"instance {inst['name']!r} needs a distinct loopback "
                 f"address (e.g. 127.0.1.N) so its kubelet is reachable "
                 f"on the standard port")
    print(f"{inst['name']}:{addrs[0]}")
EOF
)

python -m kubernetes_tpu_torch.cmd.storeserver --port "${STORE_PORT}" &
PIDS+=($!)
KTPU_CLOUD_INVENTORY="${INVENTORY}" \
python -m kubernetes_tpu_torch.cmd.apiserver --port "${PORT}" \
    --store-server "127.0.0.1:${STORE_PORT}" --reuse-port \
    --cloud-provider inventory &
PIDS+=($!)
for i in $(seq 1 60); do
    curl -sf "${MASTER}/healthz" >/dev/null 2>&1 && break
    sleep 0.5
done
curl -sf "${MASTER}/healthz" >/dev/null 2>&1 \
    || { echo "apiserver failed to become healthy on ${MASTER}" >&2; exit 1; }

KTPU_CLOUD_INVENTORY="${INVENTORY}" \
python -m kubernetes_tpu_torch.cmd.controller_manager --master "${MASTER}" \
    --cloud-provider inventory &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.scheduler --master "${MASTER}" \
    --algorithm tpu-batch &
PIDS+=($!)

# one kubelet per discovered instance, each on its own loopback address
# at the standard port (the fleet shape addons and node proxy expect)
for pair in ${PAIRS}; do
    name="${pair%%:*}"
    addr="${pair#*:}"
    python -m kubernetes_tpu_torch.cmd.kubelet --api-servers "${MASTER}" \
        --hostname-override "${name}" --address "${addr}" --port 10250 \
        --root-dir "${TMPDIR:-/tmp}/ktpu-${name}" &
    PIDS+=($!)
done

python -m kubernetes_tpu_torch.cmd.dns --master "${MASTER}" --port 10053 &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.monitoring --master "${MASTER}" --port 10251 &
PIDS+=($!)
python -m kubernetes_tpu_torch.cmd.logging --master "${MASTER}" --port 10252 &
PIDS+=($!)

echo "inventory cluster up: ${MASTER}"
echo "  instances: ${PAIRS}"
echo "  dashboard: ${MASTER}/ui/"
wait
