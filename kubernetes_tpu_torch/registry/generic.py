"""Generic declarative per-resource storage.

Port of ``kubernetes_tpu/registry/generic.py``.

Rebuild of the reference's ``etcdgeneric.Etcd`` + ``rest.Storage`` pattern
(ref: pkg/registry/generic/etcd/etcd.go:52-92 and pkg/api/rest/rest.go:34-151):
one generic registry parameterized by object type, key layout, create/update
strategies, and an attribute function for label/field selection. Every
resource (pods, services, nodes, ...) is an instance of this class plus a
small strategy — exactly the declarative shape of the reference.
"""

from __future__ import annotations

import itertools
import random
import string
import threading
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api import validation
from kubernetes_tpu_torch.api.fields import FieldSelector
from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.api.meta import accessor
from kubernetes_tpu_torch.storage.helper import StoreHelper
from kubernetes_tpu_torch.util import tracing

__all__ = ["Context", "Strategy", "GenericRegistry", "default_attr_func"]

# UID generation: one urandom-backed prefix per process + a counter.
# uuid.uuid4() pays a 16-byte urandom syscall per object (~0.1ms of the
# per-pod churn budget); uniqueness needs randomness once per process,
# not per object. uid is an opaque string (ref: docs/identifiers.md —
# "unique in space and time"), so the shape need not be RFC 4122.
_UID_NODE = uuid.uuid4().hex[:20]
_UID_SEQ = itertools.count(1)


def _next_uid() -> str:
    return f"{_UID_NODE}-{next(_UID_SEQ):012x}"


@dataclass
class Context:
    """Request context (ref: pkg/api/context.go): namespace + caller identity."""

    namespace: str = ""
    user: Optional[Any] = None

    def with_namespace(self, ns: str) -> "Context":
        return Context(namespace=ns, user=self.user)


class Strategy:
    """Create/update strategy (ref: pkg/api/rest/{create,update}.go
    RESTCreateStrategy / RESTUpdateStrategy)."""

    kind = "Object"
    namespaced = True
    allow_create_on_update = False

    def prepare_for_create(self, ctx: Context, obj: Any) -> None:
        """Mutate obj before validation/storage (clear status, defaults)."""

    def validate(self, ctx: Context, obj: Any) -> List[Exception]:
        return []

    def prepare_for_update(self, ctx: Context, new: Any, old: Any) -> None:
        pass

    def validate_update(self, ctx: Context, new: Any, old: Any) -> List[Exception]:
        return []


def default_attr_func(obj: Any) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Default label/field attributes for selection: labels + metadata.name."""
    return accessor.labels(obj), {"metadata.name": accessor.name(obj)}


class GenericRegistry:
    """One resource's storage logic (ref: etcdgeneric.Etcd).

    Declarative knobs mirror the reference's struct fields: obj_type/list_type
    (NewFunc/NewListFunc), prefix (KeyRootFunc/KeyFunc), strategy
    (Create/UpdateStrategy), ttl_func (TTLFunc), attr_func (PredicateFunc
    attributes).
    """

    def __init__(self, helper: StoreHelper, prefix: str, obj_type: Type,
                 list_type: Type, strategy: Strategy,
                 attr_func: Callable = default_attr_func,
                 ttl_func: Optional[Callable[[Any], Optional[float]]] = None):
        self.helper = helper
        self.prefix = prefix.rstrip("/")
        self.obj_type = obj_type
        self.list_type = list_type
        self.strategy = strategy
        self.attr_func = attr_func
        self.ttl_func = ttl_func
        self.kind = strategy.kind
        # (namespace, name, resourceVersion) -> attr_func result. A stored
        # revision's selectable attributes are immutable, and watch fan-out
        # evaluates every watcher's selector against the same revision —
        # N watchers pay one attr build instead of N. Bounded FIFO.
        self._attr_cache: "OrderedDict" = OrderedDict()
        self._attr_lock = threading.Lock()

    # -- keys ---------------------------------------------------------------
    def key_root(self, ctx: Context) -> str:
        if self.strategy.namespaced and ctx.namespace:
            return f"{self.prefix}/{ctx.namespace}"
        return self.prefix

    def key(self, ctx: Context, name: str) -> str:
        if not name:
            raise errors.new_bad_request("name is required")
        if self.strategy.namespaced:
            if not ctx.namespace:
                raise errors.new_bad_request(
                    f"namespace is required for {self.kind}")
            return f"{self.prefix}/{ctx.namespace}/{name}"
        return f"{self.prefix}/{name}"

    # -- verbs (ref: rest.Storage verb interfaces) --------------------------
    def new(self) -> Any:
        return self.obj_type()

    def new_list(self) -> Any:
        return self.list_type()

    def create(self, ctx: Context, obj: Any) -> Any:
        """ref: etcd.go Create + rest.BeforeCreate (pkg/api/rest/create.go)."""
        m = accessor.metadata(obj)
        if self.strategy.namespaced:
            if m.namespace and ctx.namespace and m.namespace != ctx.namespace:
                raise errors.new_bad_request(
                    f"namespace {m.namespace!r} does not match context {ctx.namespace!r}")
            m.namespace = m.namespace or ctx.namespace or api.NamespaceDefault
        if m.generate_name and not m.name:
            suffix = "".join(random.choices(string.ascii_lowercase + string.digits, k=5))
            m.name = m.generate_name + suffix
        if not m.uid:
            m.uid = _next_uid()
        if m.creation_timestamp is None:
            import datetime
            m.creation_timestamp = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        m.resource_version = ""
        self.strategy.prepare_for_create(ctx, obj)
        errs = self.strategy.validate(ctx, obj)
        if errs:
            raise errors.new_invalid(self.kind, m.name, errs)
        ttl = self.ttl_func(obj) if self.ttl_func else None
        # store-write leg of the request's trace; child_span records only
        # when this thread is inside a traced request (untraced churn
        # creates stay out of the span ring)
        with tracing.child_span("store.create", kind=self.kind):
            return self.helper.create_obj(
                self.key(ctx.with_namespace(m.namespace), m.name),
                obj, ttl=ttl)

    def get(self, ctx: Context, name: str) -> Any:
        return self.helper.extract_obj(self.key(ctx, name), self.kind, name)

    def list(self, ctx: Context, label_selector: Optional[Selector] = None,
             field_selector: Optional[FieldSelector] = None) -> Any:
        lst = self.helper.extract_to_list(self.key_root(ctx), self.list_type)
        if label_selector or field_selector:
            lst.items = [o for o in lst.items
                         if self._matches(o, label_selector, field_selector)]
        return lst

    def update(self, ctx: Context, obj: Any) -> Any:
        """ref: etcd.go Update + rest.BeforeUpdate."""
        m = accessor.metadata(obj)
        if (self.strategy.namespaced and m.namespace and ctx.namespace
                and m.namespace != ctx.namespace):
            raise errors.new_bad_request(
                f"namespace {m.namespace!r} does not match context {ctx.namespace!r}")
        key = self.key(ctx, m.name)
        try:
            old = self.helper.extract_obj(key, self.kind, m.name)
        except errors.StatusError as e:
            if errors.is_not_found(e) and self.strategy.allow_create_on_update:
                return self.create(ctx, obj)
            raise
        m.uid = accessor.metadata(old).uid
        m.creation_timestamp = accessor.metadata(old).creation_timestamp
        self.strategy.prepare_for_update(ctx, obj, old)
        errs = self.strategy.validate_update(ctx, obj, old)
        if errs:
            raise errors.new_invalid(self.kind, m.name, errs)
        if not m.resource_version:
            # unconditional update: CAS against what we just read, retrying is
            # the caller's job on conflict (matches reference SetObj semantics)
            m.resource_version = accessor.resource_version(old)
        ttl = self.ttl_func(obj) if self.ttl_func else None
        with tracing.child_span("store.update", kind=self.kind):
            return self.helper.set_obj(key, obj, ttl=ttl)

    def delete(self, ctx: Context, name: str) -> api.Status:
        self.helper.delete_obj(self.key(ctx, name), self.kind, name)
        return api.Status(status=api.StatusSuccess)

    def watch(self, ctx: Context, label_selector: Optional[Selector] = None,
              field_selector: Optional[FieldSelector] = None,
              resource_version: str = "") -> watchpkg.Watcher:
        return self.helper.watch(
            self.key_root(ctx), resource_version=resource_version,
            filter_fn=lambda o: self._matches(o, label_selector, field_selector))

    def watch_raw(self, ctx: Context,
                  label_selector: Optional[Selector] = None,
                  field_selector: Optional[FieldSelector] = None,
                  resource_version: str = "",
                  lag_limit: Optional[int] = None):
        """Raw watch + translate for the HTTP fan-out path: returns
        ``(watcher, translate)`` where ``watcher`` streams StoreEvents on a
        bounded queue and ``translate(ev)`` maps one to the API-level watch
        Event (None = filtered out) via the shared decode/attr caches. The
        caller's own thread drives translation — no per-watcher pump."""
        if label_selector is not None and label_selector.empty():
            label_selector = None
        if field_selector is not None and not field_selector.requirements:
            field_selector = None
        raw = self.helper.watch_raw(self.key_root(ctx), resource_version,
                                    lag_limit=lag_limit)
        if label_selector is None and field_selector is None:
            # unfiltered watchers (the wide-fan-out population) take the
            # decode-free fast path: (type, rv, obj_thunk) tuples
            return raw, self.helper.translate_event_fast
        filt = lambda o: self._matches(o, label_selector, field_selector)
        return raw, (lambda ev: self.helper.translate_event(ev, filt))

    # -- selection ----------------------------------------------------------
    # Sized like the helper's decode cache: a selected list walks every
    # object of the kind, so a cache smaller than the cluster (8192 here
    # once, against 20,000 pods) misses on every object of every list.
    _ATTR_CACHE_MAX = 65536

    def _attrs(self, obj: Any) -> Tuple[Dict[str, str], Dict[str, str]]:
        m = getattr(obj, "metadata", None)
        rv = getattr(m, "resource_version", "") if m is not None else ""
        name = getattr(m, "name", "") if m is not None else ""
        if not rv or not name:
            return self.attr_func(obj)
        key = (getattr(m, "namespace", ""), name, rv)
        # the read takes no lock: one OrderedDict.get is atomic, and a
        # lock taken per object of every list convoys the concurrent lists
        # of a controller manager (16 at once) behind one another; the
        # lock keeps the insert and its eviction together
        got = self._attr_cache.get(key)
        if got is None:
            got = self.attr_func(obj)
            with self._attr_lock:
                self._attr_cache[key] = got
                while len(self._attr_cache) > self._ATTR_CACHE_MAX:
                    self._attr_cache.popitem(last=False)
        return got

    def _matches(self, obj: Any, label_selector: Optional[Selector],
                 field_selector: Optional[FieldSelector]) -> bool:
        lbls, flds = self._attrs(obj)
        if label_selector is not None and not label_selector.matches(lbls):
            return False
        if field_selector is not None and not field_selector.matches(flds):
            return False
        return True
