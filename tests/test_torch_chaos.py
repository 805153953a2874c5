"""The port's crash-durable control plane on the cases of
tests/test_chaos.py: one WAL record per transaction item and one flush
per batched call, crash points before and after the append, torn txn
records, the recovery disclosure, the remote store riding a kube-store
respawn, stale pooled connections, reads retried and writes raised, the
HTTP transport's connect retry, the backoff, the solver fallback and
cooldown, and the chaos SLO rules.

Left out: the cases that load ``hack/churn_mp.py`` or ``hack/perfgate.py``,
the reference's harness scripts, which a twin would run unchanged (the
port's harness comes with a later benchmark)."""

import pytest
from test_torch_twin import port_on_the_cpu, port_twin

HARNESS = "tests hack/churn_mp.py or hack/perfgate.py, not the port"

globals().update(port_twin("test_chaos", {
    "test_parse_chaos_grammar": HARNESS,
    "test_validate_record_requires_chaos_and_store_sections": HARNESS,
    "test_perfgate_isolates_chaos_shape": HARNESS,
    "test_kill_and_respawn_every_component_e2e": HARNESS,
}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
