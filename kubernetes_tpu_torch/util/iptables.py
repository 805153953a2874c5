"""iptables wrapper seam (ref: pkg/util/iptables/iptables.go).

The reference shells out to /sbin/iptables to install portal REDIRECT
rules; every caller goes through an ``Interface`` with EnsureRule/
DeleteRule/EnsureChain semantics so tests can fake it. Here the same seam:
``IPTables`` is the protocol, ``FakeIPTables`` the in-memory rule table
used by the proxier and its tests (running iptables for real requires
root + netfilter, neither of which a test run has;
the real executor is a straight subprocess swap behind the same seam).

Port of ``kubernetes_tpu/util/iptables.py``.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

__all__ = ["IPTables", "FakeIPTables", "ExecIPTables",
           "TableNAT", "ChainPrerouting", "ChainOutput"]

TableNAT = "nat"
ChainPrerouting = "PREROUTING"
ChainOutput = "OUTPUT"


class IPTables:
    """ref: iptables.go Interface (EnsureChain/FlushChain/EnsureRule/
    DeleteRule/IsIpv6)."""

    def ensure_chain(self, table: str, chain: str) -> bool:
        """-> True if the chain already existed."""
        raise NotImplementedError

    def flush_chain(self, table: str, chain: str) -> None:
        raise NotImplementedError

    def ensure_rule(self, table: str, chain: str, *args: str) -> bool:
        """-> True if the rule already existed."""
        raise NotImplementedError

    def delete_rule(self, table: str, chain: str, *args: str) -> None:
        raise NotImplementedError


class FakeIPTables(IPTables):
    """In-memory rule table (ref: iptables_test.go fakes — but stateful, so
    the proxier's ensurePortals loop can be asserted against)."""

    def __init__(self):
        self.chains: Dict[Tuple[str, str], List[Tuple[str, ...]]] = {}
        self.calls: List[tuple] = []

    def ensure_chain(self, table: str, chain: str) -> bool:
        self.calls.append(("ensure_chain", table, chain))
        key = (table, chain)
        existed = key in self.chains
        self.chains.setdefault(key, [])
        return existed

    def flush_chain(self, table: str, chain: str) -> None:
        self.calls.append(("flush_chain", table, chain))
        self.chains[(table, chain)] = []

    def ensure_rule(self, table: str, chain: str, *args: str) -> bool:
        self.calls.append(("ensure_rule", table, chain) + args)
        rules = self.chains.setdefault((table, chain), [])
        if args in rules:
            return True
        rules.append(args)
        return False

    def delete_rule(self, table: str, chain: str, *args: str) -> None:
        self.calls.append(("delete_rule", table, chain) + args)
        rules = self.chains.get((table, chain), [])
        if args in rules:
            rules.remove(args)

    def rules(self, table: str, chain: str) -> List[Tuple[str, ...]]:
        return list(self.chains.get((table, chain), []))


class ExecIPTables(IPTables):
    """Shells out to iptables (ref: iptables.go runner). Needs root."""

    def __init__(self, binary: str = "iptables"):
        self.binary = binary

    def _run(self, *args: str, check: bool = True) -> int:
        proc = subprocess.run([self.binary] + list(args),
                              capture_output=True, text=True)
        if check and proc.returncode != 0:
            raise RuntimeError(
                f"iptables {' '.join(args)}: {proc.stderr.strip()}")
        return proc.returncode

    def ensure_chain(self, table: str, chain: str) -> bool:
        if self._run("-t", table, "-L", chain, check=False) == 0:
            return True
        self._run("-t", table, "-N", chain)
        return False

    def flush_chain(self, table: str, chain: str) -> None:
        self._run("-t", table, "-F", chain)

    def ensure_rule(self, table: str, chain: str, *args: str) -> bool:
        if self._run("-t", table, "-C", chain, *args, check=False) == 0:
            return True
        self._run("-t", table, "-A", chain, *args)
        return False

    def delete_rule(self, table: str, chain: str, *args: str) -> None:
        self._run("-t", table, "-D", chain, *args, check=False)
