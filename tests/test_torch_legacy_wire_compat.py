"""The legacy v1beta1/v1beta2 wire of the two packages against each other.

Seeded with numpy: objects of every registered kind, made with the
reference suite's fuzzer (tests/test_serialization.py) and carried into
the port over the v1 wire, encode to the same bytes in both packages in
each legacy version, and each package decodes the other's bytes to the
same object. The legacy tables (kind aliases, defaulters, field labels)
are equal. The seeded 240-request differential of
tests/test_torch_apiserver_wire.py runs again on ``/api/v1beta1`` and
``/api/v1beta2`` paths: the namespace as a query parameter, nodes as
``minions``, bodies in the legacy wire and field selectors in its
vocabulary (``DesiredState.Host``, ``id``), against a reference and a
port server side by side: equal status codes and bodies, and equal
frames on a legacy watch of each, none of which is a v1 frame while a
v1 watch of the same server sees the same events in v1. And a list of
every kind in every version, its items' bytes in the apiserver's wire
cache, encodes byte for byte as ``scheme.encode`` of the list, the
legacy ones without the cache's shortcut.
"""

import json
import re
import typing
import urllib.parse

import numpy as np
import pytest

import test_serialization as ref_fuzz
from kubernetes_tpu.api import v1beta1 as ref_v1beta1
from kubernetes_tpu.api import v1beta2 as ref_v1beta2
from kubernetes_tpu.api.latest import _ALL_KINDS as REF_KINDS
from kubernetes_tpu.api.latest import scheme as ref_scheme
from kubernetes_tpu_torch.api import v1beta1 as port_v1beta1
from kubernetes_tpu_torch.api import v1beta2 as port_v1beta2
from kubernetes_tpu_torch.api.latest import VERSIONS
from kubernetes_tpu_torch.api.latest import scheme as port_scheme
from kubernetes_tpu_torch.apiserver.http import APIServer as PortAPIServer
from kubernetes_tpu_torch.apiserver.master import Master as PortMaster
from test_torch_apiserver_wire import (N_OPS, RELABEL, SEED, _ops, _servers,
                                       _WatchStream, _Wire)

LEGACY = ("v1beta1", "v1beta2")
TABLES = {"v1beta1": (ref_v1beta1, port_v1beta1),
          "v1beta2": (ref_v1beta2, port_v1beta2)}


class _NumpyRandom:
    """The slice of ``random.Random`` the reference fuzzer calls, drawn
    from a numpy generator."""

    def __init__(self, seed):
        self.g = np.random.default_rng(seed)

    def random(self) -> float:
        return float(self.g.random())

    def randint(self, a: int, b: int) -> int:
        return int(self.g.integers(a, b + 1))

    def choice(self, seq):
        return seq[int(self.g.integers(len(seq)))]


def _pair(cls, seed):
    """A fuzzed reference object of ``cls`` (defaulted through one v1
    decode) and the port's decode of its v1 bytes."""
    ref = ref_fuzz._fuzz_dataclass(cls, _NumpyRandom(seed))
    ref = ref_scheme.decode(ref_scheme.encode(ref, "v1"))
    return ref, port_scheme.decode(ref_scheme.encode(ref, "v1"))


def test_the_port_registers_the_reference_versions():
    assert VERSIONS == ("v1", "v1beta1", "v1beta2")
    assert port_scheme.versions() == ref_scheme.versions()


@pytest.mark.parametrize("version", LEGACY)
@pytest.mark.parametrize("cls", REF_KINDS, ids=[c.__name__ for c in REF_KINDS])
def test_every_kind_encodes_and_decodes_alike(cls, version):
    for k in range(6):
        ref, port = _pair(cls, [20261017, REF_KINDS.index(cls),
                                LEGACY.index(version), k])
        ref_bytes = ref_scheme.encode(ref, version)
        port_bytes = port_scheme.encode(port, version)
        assert port_bytes == ref_bytes, (cls.__name__, k)
        # each package decodes the other's bytes to the same object
        assert port_scheme.encode(port_scheme.decode(ref_bytes), "v1") == \
            ref_scheme.encode(ref_scheme.decode(ref_bytes), "v1")
        assert ref_scheme.encode(ref_scheme.decode(port_bytes), "v1") == \
            port_scheme.encode(port_scheme.decode(port_bytes), "v1")
        # and the legacy wire's transforms invert exactly
        assert port_scheme.encode(port_scheme.decode(port_bytes), "v1") == \
            port_scheme.encode(port, "v1")


@pytest.mark.parametrize("version", LEGACY)
def test_the_legacy_tables_are_equal(version):
    ref, port = TABLES[version]
    assert port.KIND_ALIASES == ref.KIND_ALIASES
    assert sorted(port.FIELD_LABELS) == sorted(ref.FIELD_LABELS)
    labels = ["DesiredState.Host", "DesiredState.Status", "Status.Phase",
              "id", "unschedulable", "metadata.name", "spec.host", "other"]
    for kind in ref.FIELD_LABELS:
        for label in labels:
            assert port.FIELD_LABELS[kind](label, "v") == \
                ref.FIELD_LABELS[kind](label, "v"), (kind, label)
            assert port_scheme.convert_field_label(version, kind, label,
                                                   "v") == \
                ref_scheme.convert_field_label(version, kind, label, "v")
    assert sorted(port.DEFAULTERS) == sorted(ref.DEFAULTERS)
    for kind in ref.DEFAULTERS:
        cls = next(c for c in REF_KINDS if c.__name__ == kind)
        for k in range(8):
            r = ref_fuzz._fuzz_dataclass(cls, _NumpyRandom([kind.encode()[0],
                                                            k]))
            p = port_scheme.decode(ref_scheme.encode(r, "v1"),
                                   default_version="v1")
            r = ref_scheme.decode(ref_scheme.encode(r, "v1"))
            ref.DEFAULTERS[kind](r)
            port.DEFAULTERS[kind](p)
            assert port_scheme.encode(p, "v1") == ref_scheme.encode(r, "v1")
    # v1 takes its era defaults from v1beta1's table, as the reference
    for kind in ref_v1beta1.DEFAULTERS:
        assert port_scheme._defaulters[("v1", kind)] is \
            port_v1beta1.DEFAULTERS[kind]


# -- the seeded differential on the legacy paths --------------------------

_LEGACY_FIELDS = {"spec.host": "DesiredState.Host", "metadata.name": "id",
                  "status.phase": "Status.Phase"}
_V1_PATH = re.compile(
    r"/api/v1/(?:namespaces/(?P<ns>[^/]+)/)?(?P<res>[^/?]+)"
    r"(?P<rest>/[^?]*)?(?:\?(?P<q>.*))?$")


def _legacy_op(op, version):
    """One request of the v1 differential in ``version``'s wire: the
    namespace as a query parameter, ``minions`` for nodes, the body
    converted by the reference's codec, field selectors in the legacy
    vocabulary."""
    method, path, body = op
    m = _V1_PATH.match(path)
    res = "minions" if m["res"] == "nodes" else m["res"]
    query = dict(urllib.parse.parse_qsl(m["q"] or ""))
    if "fieldSelector" in query:
        label, op_, value = re.match(r"([^!=]+)(!?=)(.*)",
                                     query.pop("fieldSelector")).groups()
        query["fields"] = _LEGACY_FIELDS.get(label, label) + op_ + value
    if "labelSelector" in query:
        query["labels"] = query.pop("labelSelector")
    if m["ns"]:
        query["namespace"] = m["ns"]
    path = f"/api/{version}/{res}{m['rest'] or ''}"
    if query:
        path += "?" + urllib.parse.urlencode(query)
    if body is None or RELABEL in body:
        pass
    elif body.get("kind") == "NoSuchKind":
        body = dict(body, apiVersion=version)
    elif "kind" in body:
        body = ref_scheme.convert_wire(body, "v1", version)
    else:
        # a merge patch: v1beta1 and v1beta2 keep labels at the top
        body = {"labels": body["metadata"]["labels"]}
    return method, path, body


class _LegacyWire(_Wire):
    """``_Wire`` whose relabel edits the legacy object's top-level
    ``labels`` and ``resourceVersion``."""

    def call(self, method, path, body=None, ctype="application/json",
             norm=True):
        if body is not None and RELABEL in body:
            code, cur = _Wire.call(self, "GET", path, norm=False)
            if code != 200:
                return _Wire.call(self, "GET", path)
            cur["labels"] = body[RELABEL]
            if body["stale"]:
                cur["resourceVersion"] = "3"
            body = cur
        return _Wire.call(self, method, path, body, ctype, norm)


@pytest.mark.parametrize("version", LEGACY)
def test_seeded_legacy_differential_matches_the_reference(version):
    ops = [_legacy_op(op, version)
           for op in _ops(np.random.default_rng(SEED), N_OPS)]
    assert len(ops) >= 200
    assert any("namespace=" in p for _m, p, _b in ops)
    assert any("DesiredState.Host" in p for _m, p, _b in ops)
    ref_srv, port_srv = _servers()
    streams, wires = [], []
    try:
        for srv in (ref_srv, port_srv):
            streams.append(_WatchStream(srv, f"/api/{version}/pods?watch=1"))
            wires.append(_LegacyWire(srv))
        v1_stream = _WatchStream(port_srv, "/api/v1/pods?watch=1")
        streams.append(v1_stream)
        codes = set()
        for i, (method, path, body) in enumerate(ops):
            want = wires[0].call(method, path, body)
            got = wires[1].call(method, path, body)
            assert got == want, (i, method, path, body)
            codes.add((method, want[0]))
        assert {(m, c) for m in ("GET", "PUT", "DELETE")
                for c in (200, 404)} <= codes, codes
        assert {("POST", c) for c in (201, 400, 409, 422)} <= codes, codes
        assert ("PATCH", 200) in codes and ("PUT", 409) in codes, codes
        for w in wires:
            w.close()
        ref_srv.stop()
        port_srv.stop()
        ref_frames, port_frames, v1_frames = (s.frames() for s in streams)
    finally:
        for s in streams:
            s.close()
        ref_srv.stop()
        port_srv.stop()
    assert len(ref_frames) > 50
    assert [f["type"] for f in ref_frames].count("DELETED") > 0
    assert port_frames == ref_frames
    # the frame cache is keyed by (revision, version): the legacy watch
    # never gets a v1 frame, nor the v1 watch a legacy one
    assert {f["object"]["apiVersion"] for f in port_frames} == {version}
    assert {f["object"]["apiVersion"] for f in v1_frames} == {"v1"}
    assert [(f["type"], f["object"]["resourceVersion"])
            for f in port_frames] == \
        [(f["type"], f["object"]["metadata"]["resourceVersion"])
         for f in v1_frames]


# -- encode_list, byte for byte -------------------------------------------

_LIST_KINDS = [c for c in REF_KINDS if c.__name__.endswith("List")]


class _CountingCache(dict):
    gets = 0

    def get(self, *a):
        type(self).gets += 1
        return super().get(*a)


def _list_pair(cls, seed, n_items=3):
    """A reference list of ``cls`` with ``n_items`` fuzzed items and the
    port's decode of its v1 bytes."""
    item_cls = typing.get_args(typing.get_type_hints(cls)["items"])[0]
    rng = _NumpyRandom(seed)
    ref = cls(items=[ref_fuzz._fuzz_dataclass(item_cls, rng)
                     for _ in range(n_items)])
    ref = ref_scheme.decode(ref_scheme.encode(ref, "v1"))
    return ref, port_scheme.decode(ref_scheme.encode(ref, "v1"))


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("cls", _LIST_KINDS,
                         ids=[c.__name__ for c in _LIST_KINDS])
def test_encode_list_equals_scheme_encode(cls, version):
    srv = PortAPIServer(PortMaster()).start()
    srv._wire_cache = _CountingCache(srv._wire_cache)
    _CountingCache.gets = 0
    try:
        for k in range(4):
            ref, lst = _list_pair(cls, [SEED, _LIST_KINDS.index(cls), k])
            for n, item in enumerate(lst.items):
                meta = getattr(item, "metadata", None)
                if meta is not None:
                    meta.resource_version = str(1000 + 10 * k + n)
                    if n % 2:   # some items' bytes already in the cache
                        srv.seed_frame(item, version)
            want = port_scheme.encode(lst, version)
            assert srv.encode_list(lst, version) == want, k
            assert srv.encode_response(lst, version) == want, k
            for item in ref.items:
                meta = getattr(item, "metadata", None)
                if meta is not None:
                    meta.resource_version = str(1000 + 10 * k
                                                + ref.items.index(item))
            assert want == ref_scheme.encode(ref, version), k
    finally:
        srv.stop()
    if version != "v1":
        assert _CountingCache.gets == 0   # the cache's shortcut is v1's


def test_encode_list_of_minions_keeps_both_lists():
    """A v1beta1 MinionList carries its nodes under ``items`` and
    ``minions``; v1beta2 under ``items`` alone."""
    srv = PortAPIServer(PortMaster()).start()
    ref_nodes = [ref_fuzz._fuzz_dataclass(
        next(c for c in REF_KINDS if c.__name__ == "Node"),
        _NumpyRandom([SEED, n])) for n in range(3)]
    lst = port_scheme.decode(ref_scheme.encode(
        next(c for c in REF_KINDS if c.__name__ == "NodeList")(
            items=ref_nodes), "v1"))
    for n, node in enumerate(lst.items):
        node.metadata.resource_version = str(50 + n)
        srv.seed_frame(node, "v1beta1")
    try:
        b1 = json.loads(srv.encode_list(lst, "v1beta1"))
        b2 = json.loads(srv.encode_list(lst, "v1beta2"))
    finally:
        srv.stop()
    assert b1["kind"] == "MinionList"
    assert len(b1["items"]) == len(b1["minions"]) == 3
    assert b1["items"] == b1["minions"]
    assert b2["kind"] == "MinionList" and "minions" not in b2
    assert [i["id"] for i in b2["items"]] == [i["id"] for i in b1["items"]]
