"""kube-fairshed in the port (apiserver/fairshed.py behind the port's
``APIServer``) on the classes of tests/test_fairshed.py: flow
classification, isolated inflight budgets and queues, measured-drain
Retry-After hints and the backlog governor, over HTTP and through the
port's ``HTTPTransport``, event-priority shedding and the chaos latency
grammar of ``util/chaos.py``.

The remote store's throttle runs against the port's ``storage/remote.py``.
Left out: the cases that exercise ``hack/churn_mp.py`` and
``hack/perfgate.py``, the reference's harness scripts, which a twin would
load unchanged.
"""

from test_torch_twin import port_twin

HARNESS = "tests hack/churn_mp.py or hack/perfgate.py, not the apiserver"

globals().update(port_twin("test_fairshed", {
    "TestFeeder429Semantics": HARNESS,
    "TestOverloadRecordContract": HARNESS,
    "TestChaosLatencyGrammar::test_parse_chaos_mixes_kills_and_delays":
        HARNESS,
    "TestChaosLatencyGrammar::test_kill_grammar_unchanged": HARNESS,
}))
